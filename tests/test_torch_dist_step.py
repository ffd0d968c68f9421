"""One edge-partitioned train step across 2 and 4 gloo ranks on the CPU
against the JAX package's `make_distributed_train_step` on its virtual
mesh with the same P and the same injected parameters (the problems and
tolerances of tests/test_torch_dist.py).  Each case names the model
(BatchNorm on with cross-rank statistics, off with edge features, float32
on the rank route) and the exchange; the JAX side runs the same exchange,
except the float32 overlap, held against JAX's all_gather step (the JAX
package holds its exchanges to one another at 1e-10, tests/test_overlap.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fsw_gnn_tpu.parallel import make_distributed_train_step, make_graph_mesh
from fsw_gnn_tpu.parallel import partition as jpart

import fsw_gnn_tpu_torch as T
from test_torch_dist import SIZES, STEPS, _close, problem, runs


@pytest.mark.parametrize('P,name,exchange',
                         [(P, m, e) for P in SIZES for m, e in STEPS[P]])
def test_distributed_train_step_matches_jax(P, name, exchange):
    """One SGD(1.0) step: the loss on every rank, every parameter's summed
    gradient and BatchNorm's running statistics after the step against
    the JAX package's `make_distributed_train_step`."""
    p = problem(name)
    v = p['variables']
    params = v['params']
    bstats = {'batch_stats': v['batch_stats']} if 'batch_stats' in v else {}
    fixed = {k: a for k, a in v.items() if k not in ('params',
                                                     'batch_stats')}
    js = jpart.partition_graph(p['g'], P)
    labels, mask = jpart.shard_recipient_labels(p['y'], p['mask'], js)
    opt = optax.sgd(1.0)
    step = make_distributed_train_step(
        p['jm'], opt, js, make_graph_mesh(P), fixed_collections=fixed,
        exchange='all_gather' if name == 'f32' else exchange)
    p_new, _, b_new, loss = step(
        jax.tree_util.tree_map(jnp.array, params), opt.init(params), bstats,
        jpart.shard_node_features(p['X'], js), js, labels,
        jnp.asarray(mask, p['dtype']), jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params,
                                   p_new)
    # the JAX gradients and statistics carried into a port module by the
    # bridge, so each is found under the port's name
    want = T.fswgnn_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               {'params': grads, **fixed, **b_new}),
        device='cpu', dtype=getattr(torch, p['dtype']), **p['kw'])
    want_grads = dict(want.named_parameters())
    want_stats = dict(want.named_buffers())
    reports = runs(P, 'step')[('step', name, exchange)]
    for r in reports:
        _close(r['loss'], float(loss), p['dtype'])
        assert set(r['grads']) == {k for k, t in want_grads.items()
                                   if t.requires_grad}
        for k, g in r['grads'].items():
            _close(g, want_grads[k].detach().numpy(), p['dtype'])
        assert bool(r['stats']) == bool(b_new)
        for k, s in r['stats'].items():
            _close(s, want_stats[k].numpy(), p['dtype'], stats=True)
        for k in r['grads']:     # the ranks hold one gradient
            np.testing.assert_array_equal(r['grads'][k],
                                          reports[0]['grads'][k])
