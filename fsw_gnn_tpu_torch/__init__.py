"""fsw_gnn_tpu_torch -- the Fourier Sliced-Wasserstein GNN in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of `fsw_gnn_tpu` (JAX), one slice at a time; ROADMAP.md lists
what is ported.  It follows the JAX package's module layout and names.
Entry points run on the card unless given device='cpu'; on the CPU every
kernel is replaced by its plain PyTorch version.  This package imports no
JAX and nothing of `fsw_gnn_tpu`.
"""

from .bridge import fswconv_from_jax, fswgnn_from_jax
from .conv import FlaxBatchNorm, FSWConv
from .device import resolve_device
from .embedding import (FSWConfig, bucket_quadrature, fsw_embed_multi_table,
                        fsw_embed_table, lowclamp)
from .graph import (Graph, MultiTable, NeighborTable, auto_layout,
                    degree_classes, from_edge_index, to_multi_table,
                    to_neighbor_table)
from .models import FSWGNN, gnn_layer_conv
from .modules import FSWEmbedding
from .params import bias_shape, generate_freqs, generate_proj_vecs
from .serving import GraphServer, multi_envelope
from .train import TrainConfig, Trainer

__version__ = '0.2.0'
