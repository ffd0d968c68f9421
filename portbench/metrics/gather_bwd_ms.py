"""gather_bwd_ms (ms, device trace): device ms a step of PyTorch's index
backward, which the tables' gathers (embedding.py `X[table.idx]`) launch
for their gradient, by kernel name.  Nothing where no such kernel ran."""

from portbench.trace import device_s

NAMES = ('indexing_backward_kernel',)


def read(ctx):
    s = device_s(ctx['trace']['kernels'], NAMES)
    if s <= 0 or ctx['traced_steps'] <= 0:
        return None
    return 1e3 * s / ctx['traced_steps']
