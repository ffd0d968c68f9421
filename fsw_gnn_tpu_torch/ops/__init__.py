"""Kernels of the port, each beside its plain PyTorch version."""
from .fsw_rank import (fsw_rank_aggregate, fsw_rank_aggregate_cart,
                       fsw_rank_aggregate_cart_plain,
                       fsw_rank_aggregate_plain, fsw_rank_aggregate_proj,
                       fsw_rank_aggregate_proj_plain)
from .segcumsum import (segcumsum, segcumsum_plain, segcumsum_rows,
                        segcumsum_rows_plain, segment_boundaries)

__all__ = ['fsw_rank_aggregate', 'fsw_rank_aggregate_cart',
           'fsw_rank_aggregate_cart_plain', 'fsw_rank_aggregate_plain',
           'fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_plain',
           'segcumsum', 'segcumsum_plain', 'segcumsum_rows',
           'segcumsum_rows_plain', 'segment_boundaries']
