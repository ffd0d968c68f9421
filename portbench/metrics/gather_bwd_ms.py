"""gather_bwd_ms (ms, device trace): device ms a step of the tables' gather
backward, the port's `gather_bwd_kernel` (csrc/gather_bwd.cu, through
ops/gather_bwd.py), which the tables' gathers (embedding.py `_gather`)
launch for their source's gradient, by kernel name.  Nothing where no
such kernel ran."""

from portbench.trace import device_s

NAMES = ('gather_bwd_kernel',)


def read(ctx):
    s = device_s(ctx['trace']['kernels'], NAMES)
    if s <= 0 or ctx['traced_steps'] <= 0:
        return None
    return 1e3 * s / ctx['traced_steps']
