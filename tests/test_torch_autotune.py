"""The port's autotune (`utils/autotune.py`), its routing precedence
(`embedding._rank_rules`) and the build cache (`utils.cache.
enable_compilation_cache`) on the CPU; each case of the JAX package's
tests/test_autotune.py with the port's counterpart, and the K1 fit.

`derive_rules` and `_is_compile_error` are held equal to the JAX
package's on the same inputs.  The routing cases run on the CPU with a
CUDA device object and the card's kind stubbed (`_device_kind`): no
kernel runs, only the rule is asked."""
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fsw_gnn_tpu.utils import autotune as JAT
from fsw_gnn_tpu_torch import cli, kernels
from fsw_gnn_tpu_torch import embedding as E
from fsw_gnn_tpu_torch.ops import fsw_rank as R
from fsw_gnn_tpu_torch.utils import autotune as AT
from fsw_gnn_tpu_torch.utils import enable_compilation_cache

CARD = torch.device('cuda', 0)
V5E_MARGINS = {'dw': {32: 1.59, 64: 1.13, 128: 0.73},
               'nodw': {32: 2.6, 64: 2.3, 128: 2.3, 256: 1.10},
               'cart': {32: 9.51}}
PLAIN = E.FSWConfig(d_in=4, d_out=127, enable_bias=False)
CART = E.FSWConfig(d_in=4, n_slices=128, n_freqs=8, enable_bias=False)


@pytest.fixture
def card(monkeypatch, tmp_path):
    """An empty autotune cache, no hatch, and a card of kind `kind[0]`."""
    monkeypatch.setenv('FSW_AUTOTUNE_CACHE', str(tmp_path / 'at.json'))
    monkeypatch.delenv('FSW_ASSUME_H100_RULES', raising=False)
    kind = ['nvidia x100 test']
    monkeypatch.setattr(E, '_device_kind', lambda dev: kind[0])
    monkeypatch.setattr(AT, '_card_kind', lambda dev: kind[0])
    return kind


def test_derive_rules_matches_jax_on_v5e_margins():
    assert AT.derive_rules(V5E_MARGINS) == JAT.derive_rules(V5E_MARGINS)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(
    st.sampled_from(['dw', 'nodw', 'cart']),
    st.dictionaries(st.sampled_from([8, 16, 32, 48, 64, 128, 256]),
                    st.floats(0.0, 12.0, allow_nan=False), max_size=5),
    max_size=3))
def test_derive_rules_matches_jax_on_random_margins(margins):
    assert AT.derive_rules(margins) == JAT.derive_rules(margins)


COMPILE_STRINGS = [
    RuntimeError('RESOURCE_EXHAUSTED: Ran out of memory in VMEM'),
    RuntimeError('Mosaic failed to lower module'),
    RuntimeError('HTTP 413 payload too large'),
    RuntimeError('UNAVAILABLE: connection reset by peer'),
    TimeoutError('request timed out'),
    RuntimeError('DEADLINE_EXCEEDED while allocating vmem'),
    ValueError('some other value error'),
    RuntimeError('device busy, try again')]


@pytest.mark.parametrize('e', COMPILE_STRINGS, ids=lambda e: str(e)[:24])
def test_is_compile_error_matches_jax(e):
    assert AT._is_compile_error(e) == JAT._is_compile_error(e)


def test_port_losses_are_compile_errors():
    """The port's deterministic losses: a width whose kernel cannot hold its
    row (the ValueError of `_fits` and of an explicit 'rank'), and a card
    out of memory."""
    B = 2048
    assert R.misfit(('fsw_rank_fwd', 'fsw_rank_bwd'), B, with_dw=True)
    with pytest.raises(ValueError) as fits:
        R._fits('fsw_rank_bwd', B, with_dw=True)
    with pytest.raises(ValueError) as route:
        E._resolve_aggregate('rank', PLAIN, B)
    assert AT._is_compile_error(fits.value)
    assert AT._is_compile_error(route.value)
    assert AT._is_compile_error(torch.cuda.OutOfMemoryError(
        'CUDA out of memory. Tried to allocate 2.00 GiB'))
    assert not AT._is_compile_error(ValueError('shape mismatch'))
    # a kernel that fails to build or launch is not a loss: it raises
    assert AT._kernel_failed(kernels.KernelError('nvcc failed for x.cu'))
    assert AT._kernel_failed(RuntimeError('CUDA error: an illegal memory '
                                          'access was encountered'))
    assert not AT._kernel_failed(fits.value)


def test_table_entry_equals_the_module_constants():
    h100 = E._RANK_RULES_BY_KIND['h100']
    assert h100['k1_rho0'] == E.K1_RHO0
    assert h100['k1_d0'] == E.K1_D0
    assert h100['cap_dw'] == h100['cap_nodw'] == \
        E.RANK_AGGREGATE_MAX_BUCKET_NO_DW
    for device in (None, 'cpu', torch.device('cpu')):
        assert E._rank_rules(device) is h100


def test_unknown_kind_falls_back_to_sort(card, monkeypatch):
    assert E._rank_rules(CARD) is None
    assert E._resolve_aggregate('auto', PLAIN, 32, device=CARD) == 'sort'
    assert E._resolve_aggregate('auto', CART, 32, 127, False,
                                device=CARD) == 'sort'
    # an explicit 'rank' still routes by the kernels' needs and K1's fit
    assert E._resolve_aggregate('rank', PLAIN, 32, device=CARD) == 'rank'
    assert E._resolve_aggregate('rank', E.FSWConfig(d_in=4, d_out=9), 16, 9,
                                False, 0.1, device=CARD) == 'rank_proj'
    # the hatch: assume the H100's rules
    monkeypatch.setenv('FSW_ASSUME_H100_RULES', '1')
    assert E._rank_rules(CARD) is E._RANK_RULES_BY_KIND['h100']
    assert E._resolve_aggregate('auto', PLAIN, 32, device=CARD) == 'rank'
    assert E._resolve_aggregate('auto', PLAIN, 129, device=CARD) == 'sort'


def test_routes_on_the_h100_and_the_cpu_are_the_tables(card):
    """A card the table names routes as the CPU does, whatever its cache
    holds (the table beats the cache on a known kind)."""
    card[0] = 'nvidia h100 80gb hbm3'
    AT._write_cache(card[0], dict(AT.derive_rules({'dw': {32: 0.5}}),
                                  k1_rho0=0.0, k1_d0=0.0))
    assert AT.cached_rules(card[0])['cap_dw'] == 0
    assert E._rank_rules(CARD) is E._RANK_RULES_BY_KIND['h100']
    cfg = E.FSWConfig(d_in=64, d_out=127)
    for B in (8, 16, 32, 100, 128, 129, 256):
        for wg in (False, True):
            for rho in (None, 0.05, 0.5, 9.0):
                want = E._resolve_aggregate('auto', cfg, B, 127, wg, rho)
                assert E._resolve_aggregate('auto', cfg, B, 127, wg, rho,
                                            device=CARD) == want
                assert E._resolve_aggregate('auto', cfg, B, 127, wg, rho,
                                            device='cpu') == want


def test_autotune_cache_roundtrip_enables_kernel(card, tmp_path):
    assert E._resolve_aggregate('auto', PLAIN, 32, device=CARD) == 'sort'
    AT._write_cache(card[0], AT.derive_rules(V5E_MARGINS))
    assert E._resolve_aggregate('auto', PLAIN, 32, device=CARD) == 'rank'
    assert E._resolve_aggregate('auto', PLAIN, 128, device=CARD) == 'sort'
    assert E._resolve_aggregate('auto', PLAIN, 128, weights_grad=False,
                                device=CARD) == 'rank'
    assert E._resolve_aggregate('auto', PLAIN, 256, weights_grad=False,
                                device=CARD) == 'sort'
    with open(tmp_path / 'at.json') as f:
        assert card[0] in json.load(f)


def test_cached_k1_fit_is_honoured(card):
    """A cached K1 crossover decides between K1 and K2 on that card; the
    table's decides where the cache has none."""
    cfg = E.FSWConfig(d_in=64, d_out=127)
    args = ('auto', cfg, 16, 127, False)
    AT._write_cache(card[0], dict(cap_dw=128, cap_nodw=128))
    assert E._resolve_aggregate(*args, 9.0, device=CARD) == 'rank_proj'
    AT._write_cache(card[0], dict(cap_dw=128, cap_nodw=128, k1_rho0=0.0,
                                  k1_d0=10.0))
    assert E._resolve_aggregate(*args, 9.0, device=CARD) == 'rank'
    assert E._resolve_aggregate(*args, 9.0) == 'rank_proj'


def test_autotune_end_to_end_with_fake_measurement(card):
    """autotune_rank_rules with an injected measurement: derives, caches,
    and `_resolve_aggregate` picks the cached rules up."""
    margins = {'dw': {32: 2.0, 64: 0.9}, 'nodw': {32: 3.0, 64: 2.5, 128: 0.8},
               'cart': {32: 0.8}}
    rules = AT.autotune_rank_rules(measure_fn=lambda device: margins,
                                   device='cpu')
    assert rules['cap_dw'] == 32 and rules['cap_nodw'] == 64
    assert rules['source'] == 'autotune'
    assert rules['margins']['dw'] == {'32': 2.0, '64': 0.9}
    assert AT.cached_rules(card[0]) == json.loads(json.dumps(rules))
    assert E._resolve_aggregate('auto', PLAIN, 32, device=CARD) == 'rank'
    assert E._resolve_aggregate('auto', PLAIN, 64, device=CARD) == 'sort'
    assert E._resolve_aggregate('auto', PLAIN, 64, weights_grad=False,
                                device=CARD) == 'rank'


def test_transient_failure_skips_cache(card, tmp_path):
    rules = AT.autotune_rank_rules(
        measure_fn=lambda device: ({'dw': {32: 2.0}, 'nodw': {32: 3.0},
                                    'cart': {}}, ['cart B=32']),
        device='cpu')
    assert rules['transient_failures'] == ['cart B=32']
    assert rules['cap_dw'] == 32
    assert not (tmp_path / 'at.json').exists()


def _tiny(**kw):
    return AT._measure_margins(**dict(
        dict(buckets=(8,), entries=64, s=8, f_cart=2, cart_buckets=(8,),
             k1_ds=(8,), k1_rhos=(0.5, 2.0), k1_nodes=32, k1_bucket=4,
             steps=2, calls=1, device='cpu'), **kw))


def test_measure_margins_runs_on_cpu_tiny():
    """The real harness runs end to end on the plain versions (tiny
    shapes): every mode's cells give finite positive margins, and the K1
    ladder's cells carry what `fit_k1_rule` reads."""
    margins, transient, cells = _tiny()
    assert transient == []
    for mode in ('dw', 'nodw', 'cart'):
        (b, m), = margins[mode].items()
        assert b == 8 and np.isfinite(m) and m > 0
    for mode in ('k1', 'k1_fwd'):
        assert sorted(margins[mode]) == [(8, 0.5), (8, 2.0)]
        assert all(np.isfinite(m) and m > 0
                   for m in margins[mode].values())
    k1 = [c for c in cells if c['mode'] == 'k1']
    assert [c['R'] for c in k1] == [4, 16]
    assert all(c['slices'] == 127 and c['rho'] == c['R'] * 4 / 32
               for c in k1)
    rules = AT.autotune_rank_rules(measure_fn=lambda device: (
        margins, transient, cells), write_cache=False, device='cpu')
    assert {'k1_rho0', 'k1_d0', 'k1_fwd_rho0', 'k1_fwd_d0'} <= set(rules)
    assert rules['margins']['k1'].keys() == {'8,0.5', '8,2.0'}


def test_misfit_and_oom_lose_and_kernel_failures_raise(monkeypatch):
    """A width the kernels cannot hold loses without running (margin 0),
    so does a card out of memory; a kernel that fails raises out."""
    real = R.misfit
    monkeypatch.setattr(R, 'misfit', lambda names, B, *a, **k: (
        ('fsw_rank_bwd', 1) if 'fsw_rank_bwd' in names else
        real(names, B, *a, **k)))
    margins, _, _ = _tiny()
    assert margins['dw'] == {8: 0.0} and margins['nodw'] == {8: 0.0}
    assert margins['cart'][8] > 0 and margins['k1'][(8, 0.5)] > 0
    monkeypatch.setattr(R, 'misfit', real)

    real_ms = AT._ms

    def failing(err):
        """`_ms` whose first call (the rank route's) raises `err`."""
        raised = []

        def ms(fn, *a):
            if not raised:
                raised.append(err)
                raise err
            return real_ms(fn, *a)
        return ms
    monkeypatch.setattr(AT, '_ms', failing(torch.cuda.OutOfMemoryError(
        'CUDA out of memory.')))
    margins, transient, _ = _tiny()            # dw's rank route first
    assert margins['dw'] == {8: 0.0} and transient == []
    assert margins['nodw'][8] > 0
    monkeypatch.setattr(AT, '_ms', failing(kernels.KernelError(
        'fsw_rank_fwd launch failed: CUDA error 1')))
    with pytest.raises(kernels.KernelError):
        _tiny()


def test_routes_disagreeing_raise(monkeypatch):
    """The forward check before timing raises where the rank route departs
    from the sort route."""
    real = E.bucket_quadrature

    def off(P, wn, pad, f, cfg, agg, **kw):
        out = real(P, wn, pad, f, cfg, agg, **kw)
        return out + 1.0 if agg == 'rank' else out
    monkeypatch.setattr(E, 'bucket_quadrature', off)
    with pytest.raises(RuntimeError, match='disagree'):
        _tiny()


def test_cli_autotune_dry_run_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv('FSW_AUTOTUNE_CACHE', str(tmp_path / 'at.json'))
    monkeypatch.setattr(AT, '_measure_margins', lambda device: (
        V5E_MARGINS, []))
    assert cli.main(['autotune', '--dry-run', '--device', 'cpu']) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line['cache'] is None
    assert line['rules']['cap_dw'] == 64 and line['rules']['cap_nodw'] == 128
    assert not (tmp_path / 'at.json').exists()
    assert cli.main(['autotune', '--device', 'cpu']) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line['cache'] == str(tmp_path / 'at.json')
    assert AT.cached_rules('cpu')['cap_dw'] == 64


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason='a CUDA device is present; the refusal cannot '
                           'be shown')
def test_cli_autotune_needs_the_card():
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['autotune', '--dry-run'])


# ---- the K1 fit -------------------------------------------------------------

# the nine measured points in the comment at embedding.K1_RHO0: (rho, D,
# K1 ms, unfused ms, graph); the bench graph has 8192 nodes and S = 2D - 1
# slices, Cora's layer 0 2708 nodes and 2865 slices
NINE = [(8.8, 256, 3.914, 8.913, 'bench'), (9.8, 256, 4.926, 12.27, 'bench'),
        (8.8, 512, 12.67, 9.81, 'bench'), (9.8, 512, 16.33, 13.32, 'bench'),
        (0.69, 512, 1.159, 1.346, 'bench'),
        (0.69, 1024, 3.986, 2.511, 'bench'),
        (0.17, 1024, 1.154, 1.611, 'bench'),
        (0.047, 1433, 0.510, 1.145, 'cora'), (8.0, 1433, 27.92, 12.32, 'cora')]


def _nine():
    return [dict(rho=r, D=D, fused_ms=f, unfused_ms=u,
                 nodes=8192 if g == 'bench' else 2708,
                 slices=2 * D - 1 if g == 'bench' else 2865)
            for r, D, f, u, g in NINE]


def test_fit_k1_rule_decides_the_nine_points_as_the_constants():
    fit = AT.fit_k1_rule(_nine())
    assert fit['k1_misjudged'] == []
    for p in _nine():
        want = E._k1_faster(p['D'], p['rho'])
        assert want == (p['fused_ms'] < p['unfused_ms'])
        assert E._k1_faster(p['D'], p['rho'], dict(
            k1_rho0=fit['k1_rho0'], k1_d0=fit['k1_d0'])) == want


@settings(max_examples=60, deadline=None)
@given(st.floats(0.05, 2.0), st.floats(50.0, 1500.0),
       st.integers(0, 2 ** 31 - 1))
def test_fit_k1_rule_separates_the_model_it_fits(rho0, d0, seed):
    """On times drawn from the cost model itself (K1 a rho D, the unfused
    route b D + c rho, a little noise), the fit judges every decisive
    point as the measurement does."""
    rng = np.random.default_rng(seed)
    a = 1e-9
    pts = []
    for D in (64, 128, 256, 512, 1024, 1433):
        for rho in (0.05, 0.2, 0.7, 2.0, 9.0):
            ns = 8192 * (2 * max(D, 64) - 1)
            noise = rng.uniform(0.97, 1.03, 2)
            pts.append(dict(D=D, rho=rho, nodes=8192,
                            slices=2 * max(D, 64) - 1,
                            fused_ms=ns * a * rho * D * noise[0] + 1e-3,
                            unfused_ms=ns * a * (rho0 * D + d0 * rho)
                            * noise[1] + 1e-3))
    assert AT.fit_k1_rule(pts)['k1_misjudged'] == []


def test_fit_k1_rule_one_sided_ladders():
    """Where K1 always wins, or never, the rule says so on every point."""
    base = [dict(D=D, rho=rho, nodes=8192, slices=2 * D - 1)
            for D in (64, 512) for rho in (0.2, 9.0)]
    for k1_wins in (True, False):
        pts = [dict(p, fused_ms=1.0 if k1_wins else 3.0,
                    unfused_ms=3.0 if k1_wins else 1.0) for p in base]
        fit = AT.fit_k1_rule(pts)
        assert fit['k1_misjudged'] == []
        assert all(AT._k1_rule(p['D'], p['rho'], fit['k1_rho0'],
                               fit['k1_d0']) == k1_wins for p in pts)


# ---- the build cache -------------------------------------------------------

def test_enable_compilation_cache_builds_the_host_library_there(
        monkeypatch, tmp_path):
    """`enable_compilation_cache(dir)` moves the hash-named builds: the
    host library (`csrc/fswgraph.cpp`, built by c++) lands in dir and
    loads from there; the default stays the package's `_build/`."""
    assert kernels.BUILD_DIR.name == '_build'
    monkeypatch.setattr(kernels, 'BUILD_DIR', kernels.BUILD_DIR)
    monkeypatch.setattr(kernels, '_libs', {})
    got = enable_compilation_cache(str(tmp_path / 'cache' / '..' / 'build'))
    assert got == os.path.abspath(tmp_path / 'build')
    assert kernels.BUILD_DIR == tmp_path / 'build'
    lib = kernels.load_host('fswgraph')
    target = kernels._host_target('fswgraph')
    assert target.parent == tmp_path / 'build' and target.exists()
    assert lib._name == str(target)


def test_train_config_compilation_cache(monkeypatch, tmp_path):
    """TrainConfig(compilation_cache=...) and `cli train
    --compilation-cache` point the builds at the directory."""
    from fsw_gnn_tpu_torch.data.datasets import synthetic_planted_partition
    from fsw_gnn_tpu_torch.train import TrainConfig, Trainer
    monkeypatch.setattr(kernels, 'BUILD_DIR', kernels.BUILD_DIR)
    data = synthetic_planted_partition(num_nodes=40, num_classes=2,
                                       feat_dim=4, seed=0)
    Trainer(data, TrainConfig(hidden_dims=(4,), epochs=1,
                              compilation_cache=str(tmp_path / 'a')),
            device='cpu')
    assert kernels.BUILD_DIR == tmp_path / 'a' and (tmp_path / 'a').is_dir()
    seen = []
    monkeypatch.setattr(cli, 'cmd_train', lambda args: seen.append(
        args.compilation_cache) or 0)
    p = cli.main(['train', '--compilation-cache', str(tmp_path / 'b'),
                  '--device', 'cpu'])
    assert p == 0 and seen == [str(tmp_path / 'b')]


def test_device_kind_is_looked_up_once_per_index(monkeypatch):
    """The card's name is asked once per device index and remembered: a
    forward on a known card reads no file and waits for nothing."""
    asked = []
    monkeypatch.setattr(E, '_KINDS', {})
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda i: asked.append(i) or 'NVIDIA H100 80GB HBM3')
    monkeypatch.setattr(AT, 'cached_rules', lambda kind: pytest.fail(
        'the cache was read for a card the table names'))
    for _ in range(3):
        assert E._rank_rules(CARD) is E._RANK_RULES_BY_KIND['h100']
        assert E._rank_rules(torch.device('cuda', 1)) is \
            E._RANK_RULES_BY_KIND['h100']
    assert asked == [0, 1]
