"""k1_roofline_pct (%, device trace): 100 x the floor of a step's K1f and
K1b calls (workmodel.k1_work, real entries) over the device time a step of
the kernels their libraries launch (csrc/fsw_rank_fwdp.cu,
fsw_rank_bwdp.cu and the shared backward entry and row-sum kernels), by
kernel name.  Nothing where no such kernel ran."""

from portbench.trace import device_s

NAMES = ('fsw_rank_fwdp_kernel', 'bwdp_proj_kernel', 'bwdp_dz_kernel',
         'bwdp_dv_kernel', 'rank_bwd_entry_kernel<1,', 'sum_rows_kernel')


def read(ctx):
    s = device_s(ctx['trace']['kernels'], NAMES)
    if s <= 0:
        return None
    return 100.0 * ctx['k1']['floor_s'] * ctx['traced_steps'] / s
