"""`utils.cache.CountingGraph`, the port's counterpart of `CountingJit`
(tests/test_cache.py), on the CPU, where it runs each key eagerly and
counts the keys as the card counts its captured graphs.  No tolerance:
the results are compared exactly."""
import sys
import threading

import torch

from fsw_gnn_tpu_torch.utils.cache import CountingGraph


def test_counting_graph_monotone_and_keyed():
    """One count a new (route, shapes, dtypes) key; repeats and other
    values of a known key count nothing; the count never falls."""
    cg = CountingGraph({'add': lambda x, y: x + y, 'mul': lambda x: x * 2},
                       'cpu')
    a = torch.ones(4)
    assert cg.num_compiles == 0
    assert torch.equal(cg('add', a, a), torch.full((4,), 2.0))
    assert cg.num_compiles == 1
    assert torch.equal(cg('add', a + 1, a), torch.full((4,), 3.0))
    assert cg.num_compiles == 1
    cg('add', torch.ones(8), torch.ones(8))            # a new shape
    assert cg.num_compiles == 2
    cg('add', a.double(), a.double())                  # a new dtype
    assert cg.num_compiles == 3
    cg('mul', a)                                       # a new route
    cg('mul', a)
    assert cg.num_compiles == 4
    assert not cg.capture     # the CPU runs eagerly


def test_counting_graph_thread_safe_cold_key():
    """Four threads racing a cold key count it once, and each gets its
    own right result."""
    calls = []

    def slow(x):
        calls.append(1)
        return x * 2.0
    cg = CountingGraph({'r': slow}, 'cpu')
    xs = torch.arange(8, dtype=torch.float32)
    barrier = threading.Barrier(4)
    outs = [None] * 4

    def worker(i):
        barrier.wait()
        outs[i] = cg('r', xs + i)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert cg.num_compiles == 1
    for i, o in enumerate(outs):
        assert float(o[3]) == 2.0 * (3 + i)


def test_counting_graph_stress():
    """More threads than cores on four keys, with a short switch
    interval: the count is the number of keys, and no call gets another
    call's result (a lost update or a shared buffer would break one)."""
    cg = CountingGraph({'a': lambda x: x + 1, 'b': lambda x: x * 3}, 'cpu')
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for k in range(50):
                n = 4 + (i + k) % 2
                route = 'a' if k % 2 else 'b'
                x = torch.full((n,), float(i * 100 + k))
                want = x + 1 if route == 'a' else x * 3
                if not torch.equal(cg(route, x), want):
                    errors.append((i, k))
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert cg.num_compiles == 4
