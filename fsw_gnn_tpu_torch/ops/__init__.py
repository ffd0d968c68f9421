"""Kernels of the port, each beside its plain PyTorch version."""
from .fsw_rank import (fsw_rank_aggregate, fsw_rank_aggregate_bwd,
                       fsw_rank_aggregate_cart, fsw_rank_aggregate_cart_bwd,
                       fsw_rank_aggregate_cart_plain,
                       fsw_rank_aggregate_plain, fsw_rank_aggregate_proj,
                       fsw_rank_aggregate_proj_bwd,
                       fsw_rank_aggregate_proj_plain)
from .gather_bwd import gather_bwd, gather_bwd_plain, gather_order
from .segcumsum import (segcumsum, segcumsum_plain, segcumsum_rows,
                        segcumsum_rows_plain, segment_boundaries)

__all__ = ['fsw_rank_aggregate', 'fsw_rank_aggregate_cart',
           'fsw_rank_aggregate_cart_plain', 'fsw_rank_aggregate_plain',
           'fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_plain',
           'gather_bwd', 'gather_bwd_plain', 'gather_order',
           'launch_counters', 'launch_counts', 'reset_launches',
           'segcumsum', 'segcumsum_plain', 'segcumsum_rows',
           'segcumsum_rows_plain', 'segment_boundaries']


def launch_counters():
    """Each kernel of the model's paths by name, as its wrapper: a
    wrapper's `launches` counts the launches of its kernel."""
    return {'fsw_rank_fwdp': fsw_rank_aggregate_proj,
            'fsw_rank_bwdp': fsw_rank_aggregate_proj_bwd,
            'fsw_rank_fwd': fsw_rank_aggregate,
            'fsw_rank_bwd': fsw_rank_aggregate_bwd,
            'segcumsum': segcumsum,
            'fsw_rank_cart_fwd': fsw_rank_aggregate_cart,
            'fsw_rank_cart_bwd': fsw_rank_aggregate_cart_bwd,
            'gather_bwd': gather_bwd}


def launch_counts():
    """{kernel name: launches} of this process."""
    return {k: w.launches for k, w in launch_counters().items()}


def reset_launches():
    """Every count of `launch_counters` to 0."""
    for w in launch_counters().values():
        w.launches = 0
