"""segment_reduce_ms (ms, device trace): device ms a step of the kernels of
`torch.segment_reduce`, which the CSR route's sorted segment sums
(ops/segment.py `_sum_runs`) launch: its one-thread-a-segment forward and
backward kernels and cub's segmented reduce, by kernel name.  Nothing
where no such kernel ran."""

from portbench.trace import device_s

NAMES = ('segment_reduce_forward_kernel', 'segment_reduce_backward_kernel',
         'DeviceSegmentedReduceKernel')


def read(ctx):
    s = device_s(ctx['trace']['kernels'], NAMES)
    if s <= 0 or ctx['traced_steps'] <= 0:
        return None
    return 1e3 * s / ctx['traced_steps']
