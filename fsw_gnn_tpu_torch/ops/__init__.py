"""Kernels of the port, each beside its plain PyTorch version."""
from .fsw_rank import fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_plain

__all__ = ['fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_plain']
