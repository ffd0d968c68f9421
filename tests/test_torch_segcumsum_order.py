"""The segmented cumsum kernel's order of work (kernel K3,
fsw_gnn_tpu_torch/csrc/segcumsum.cu), emulated in numpy and held against
itself and against the plain PyTorch version.  This file imports no JAX:
`tests/test_torch_cuda.py` holds the kernel on the card bit for bit
against `emulate`.

The emulation follows the kernel step by step, in the working dtype (every
add rounded to float32 or float64, in the kernel's order): a row cut into
tiles of THREADS x 16 elements, taken in processing order (from the row's
end in reverse); in each tile every thread scans its 16 consecutive
elements over (value, start flag) pairs, the thread totals are scanned by
the warp shuffle scan (offsets 1, 2, 4, 8, 16), the warp totals by the same
scan in warp 0; a tile that holds a start publishes its trailing segment's
total as its inclusive prefix, one that does not publishes that total as
its aggregate and, once its carry is known, carry + aggregate as its
prefix; the carry is the fold, in tile order, of a published prefix among
the 32 tiles before and the aggregates after it.

Which prefix the look-back finds depends on timing on the card (the
kernel's look-back warp also scans the previous tile's last warp again,
which gives that tile's prefix bit for bit, the nearest pick).  The
property the kernel promises, the same bits whichever it finds, is tested
here by letting the emulation pick the nearest, the farthest or a random
one: np.array_equal on the bits, no tolerance.  Against the plain version
(the doubling scan, any order): per element 8 eps x the segment's prefix
of |v|, the kernel's tolerance on the card.

Inputs: tile edges (segments ending on and crossing tile boundaries),
singletons, one segment over more tiles than the look-back window, random
segments of average 32 and 4096, ragged row lengths, forward and reverse,
ids and mask, float32 and float64.
"""
import numpy as np
import pytest
import torch

from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_plain,
                                             segcumsum_rows_plain,
                                             segment_boundaries)

ITEMS, WINDOW, THREADS = 16, 32, 256


def _starts(m, ids=None, end=None, reverse=False):
    """Start flags (m,) in original order: where the kernel's scan in the
    given direction restarts."""
    s = np.zeros(m, bool)
    if reverse:
        s[-1] = True
        if ids is not None:
            s[:-1] |= ids[:-1] != ids[1:]
        else:
            s |= end != 0
    else:
        s[0] = True
        if ids is not None:
            s[1:] |= ids[1:] != ids[:-1]
        else:
            s[1:] |= end[:-1] != 0
    return s


def _warp_scan(v, f):
    """The kernel's warp_scan over the last axis (32 lanes): Hillis-Steele
    with offsets 1 .. 16, (v, f) then (pv, pf) = (f ? v : pv + v, f | pf)."""
    v, f = v.copy(), f.copy()
    for o in (1, 2, 4, 8, 16):
        pv = np.zeros_like(v)
        pf = np.zeros_like(f)
        pv[..., o:], pf[..., o:] = v[..., :-o], f[..., :-o]
        upd = np.zeros(v.shape, bool)
        upd[..., o:] = True
        v = np.where(upd & ~f, pv + v, v)
        f = np.where(upd, f | pf, f)
    return v, f


def _shift1(a):
    out = np.zeros_like(a)
    out[..., 1:] = a[..., :-1]
    return out


def _tile(x, s, threads):
    """One tile in processing order: x (TILE,) values, s (TILE,) start
    flags.  Returns (aggregate, has_start, finish) where finish(carry)
    gives the tile's outputs."""
    dt = x.dtype.type
    warps = threads // 32
    x = x.reshape(threads, ITEMS)
    s = s.reshape(threads, ITEMS)
    loc = np.empty_like(x)
    acc = np.zeros(threads, x.dtype)
    fl = np.zeros(threads, bool)
    seen = np.zeros((threads, ITEMS), bool)
    for k in range(ITEMS):
        acc = np.where(s[:, k], x[:, k], acc + x[:, k])
        fl |= s[:, k]
        loc[:, k] = acc
        seen[:, k] = fl
    iv, ifl = _warp_scan(acc.reshape(warps, 32), fl.reshape(warps, 32))
    xv, xf = _shift1(iv), _shift1(ifl)
    a = np.zeros(32, x.dtype)
    af = np.zeros(32, bool)
    a[:warps], af[:warps] = iv[:, 31], ifl[:, 31]
    a, af = _warp_scan(a, af)
    tot, totf = a[warps - 1], af[warps - 1]
    wv, wf = _shift1(a)[:warps], _shift1(af)[:warps]
    ex = np.where(xf, xv, wv[:, None] + xv).reshape(-1)
    exf = (xf | wf[:, None]).reshape(-1)

    def finish(carry):
        inc = np.where(exf, ex, dt(carry) + ex)
        return np.where(seen, loc, inc[:, None] + loc).reshape(-1)
    return tot, bool(totf), finish


def emulate(values, ids=None, end=None, reverse=False, pick='nearest',
            threads=THREADS, seed=0):
    """The kernel's output for values (rows, m) (float32 or float64) and
    the ids or the is_end mask (m,) that every row shares.  `pick` chooses
    which published prefix each look-back finds: 'nearest', 'farthest' or
    'random' (from `seed`)."""
    rng = np.random.default_rng(seed)
    values = np.asarray(values)
    rows, m = values.shape
    tile = threads * ITEMS
    tpr = -(-m // tile)
    s = _starts(m, ids, end, reverse)
    padded = np.ones(tpr * tile, bool)
    padded[:m] = s
    out = np.empty_like(values)
    for r in range(rows):
        v = np.zeros(tpr * tile, values.dtype)
        v[:m] = values[r]
        sp = padded
        if reverse:
            v, sp = v[::-1].copy(), sp[::-1].copy()
        res = np.empty_like(v)
        agg, pre, has = [], [], []
        for t in range(tpr):
            sl = slice(t * tile, (t + 1) * tile)
            tot, totf, finish = _tile(v[sl], sp[sl], threads)
            carry = values.dtype.type(0)
            if not sp[t * tile]:
                # the tiles whose prefix the look-back may find: in the
                # window, from the nearest one that holds a start
                cands = list(range(max(t - WINDOW, _last_start(has, t)), t))
                k = {'nearest': t - 1, 'farthest': cands[0],
                     'random': int(rng.choice(cands))}[pick]
                carry = pre[k]
                for j in range(k + 1, t):
                    carry = carry + agg[j]
            agg.append(tot)
            has.append(totf)
            pre.append(tot if totf else carry + tot)
            res[sl] = finish(carry)
        out[r] = (res[::-1] if reverse else res)[:m]
    return out


def _last_start(has, t):
    """The nearest tile before t that holds a start."""
    return max(j for j in range(t) if has[j])


def _bits(a):
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _segment_ids(rng, m, kind):
    """Sorted segment ids (m,) of one kind of segment structure."""
    tile = THREADS * ITEMS
    if kind == 'singletons':
        return np.arange(m, dtype=np.int32)
    if kind == 'one segment':
        return np.zeros(m, np.int32)
    if kind == 'tile edges':
        # segments ending on a tile boundary, one element after it, and
        # one crossing two boundaries
        cuts = [tile, tile + 1, 2 * tile - 1, 4 * tile + 5]
        return np.searchsorted(np.array(cuts), np.arange(m),
                               side='right').astype(np.int32)
    avg = int(kind.split()[1])
    return np.sort(rng.integers(0, max(m // avg, 1), m)).astype(np.int32)


CASES = [('tile edges', 5 * 4096 + 77, 256), ('singletons', 3 * 4096 + 5, 256),
         ('one segment', 40 * 512 + 3, 32), ('avg 32', 3 * 4096 + 1000, 256),
         ('avg 4096', 6 * 4096, 256), ('avg 600', 45 * 512, 32)]


@pytest.mark.parametrize('kind,m,threads', CASES)
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_same_bits_whichever_prefix_found(kind, m, threads, reverse, dtype):
    """Nearest, farthest and random picks of the look-back, and ids against
    the mask: the same bits.  'one segment' at 32 threads spans 41 tiles,
    more than the 32-tile window, so the farthest pick is a non-start
    tile's prefix."""
    rng = np.random.default_rng(m)
    ids = _segment_ids(rng, m, kind)
    end = segment_boundaries(torch.from_numpy(ids)).numpy()
    v = rng.standard_normal((2, m)).astype(dtype)
    ref = emulate(v, ids=ids, reverse=reverse, threads=threads)
    for got in (emulate(v, end=end, reverse=reverse, threads=threads),
                emulate(v, ids=ids, reverse=reverse, threads=threads,
                        pick='farthest'),
                emulate(v, end=end, reverse=reverse, threads=threads,
                        pick='random', seed=1),
                emulate(v, ids=ids, reverse=reverse, threads=threads,
                        pick='random', seed=2)):
        assert np.array_equal(_bits(got), _bits(ref))


def within_prefix(got, values, ids=None, end=None, reverse=False):
    """Per element |got - plain| <= 8 eps (the segment's prefix of |v|,
    its suffix in reverse); values (rows, m)."""
    v = torch.from_numpy(np.ascontiguousarray(values))
    mask = (torch.from_numpy(end) if end is not None else
            segment_boundaries(torch.from_numpy(ids)))
    want = segcumsum_rows_plain(v.double(), mask, reverse=reverse)
    prefix = segcumsum_rows_plain(v.double().abs(), mask, reverse=reverse)
    eps = np.finfo(values.dtype).eps
    err = (torch.from_numpy(np.asarray(got, np.float64)) - want).abs()
    return bool(torch.all(err <= 8 * eps * prefix)), float(
        (err / (eps * prefix).clamp(min=1e-300)).max())


@pytest.mark.parametrize('kind,m,threads', CASES)
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_emulation_within_prefix_of_plain(kind, m, threads, reverse, dtype):
    rng = np.random.default_rng(m + 1)
    ids = _segment_ids(rng, m, kind)
    v = rng.standard_normal((2, m)).astype(dtype)
    ok, worst = within_prefix(emulate(v, ids=ids, reverse=reverse,
                                      threads=threads), v, ids=ids,
                              reverse=reverse)
    assert ok, worst


@pytest.mark.parametrize('n', [1, 2, 17, 4096, 4097, 10000])
@pytest.mark.parametrize('reverse', [False, True])
def test_short_and_ragged_rows(n, reverse):
    """n = 1, a tile and one more, ragged lengths; nonnegative float32
    values in long segments (the largest prefixes)."""
    rng = np.random.default_rng(n)
    ids = np.sort(rng.integers(0, max(n // 700, 1), n)).astype(np.int32)
    v = np.abs(rng.standard_normal((3, n))).astype(np.float32)
    got = emulate(v, ids=ids, reverse=reverse)
    ok, worst = within_prefix(got, v, ids=ids, reverse=reverse)
    assert ok, worst


@pytest.mark.parametrize('by', ['ids', 'mask'])
@pytest.mark.parametrize('n', [1, 9, 300, 5000])
def test_plain_reverse_is_flip_scan_flip(by, n):
    """The CPU's reverse scan (the backward of `segcumsum`, with the ids
    and with the mask, and `segcumsum_rows_plain(reverse=True)`) against
    flip, forward scan, flip of the plain version (float64)."""
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(np.sort(rng.integers(0, max(n // 7, 1), n)))
    v = torch.from_numpy(rng.standard_normal((4, n)))
    mask = segment_boundaries(ids)
    # the flipped array ends where the original starts
    kw_flip = (dict(segment_ids=ids.flip(0)) if by == 'ids' else
               dict(boundaries=torch.cat([mask[:-1].flip(0),
                                          mask.new_ones(1)])))
    want = torch.stack([segcumsum_plain(v[r].flip(0), **kw_flip).flip(0)
                        for r in range(v.shape[0])])
    kw = dict(segment_ids=ids) if by == 'ids' else dict(boundaries=mask)
    x = torch.zeros(n, dtype=torch.float64, requires_grad=True)
    for r in range(v.shape[0]):
        got, = torch.autograd.grad(segcumsum(x, **kw), x, v[r])
        torch.testing.assert_close(got, want[r], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(segcumsum_rows_plain(v, mask, reverse=True),
                               want, rtol=1e-12, atol=1e-12)
