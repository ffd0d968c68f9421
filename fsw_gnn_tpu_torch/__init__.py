"""fsw_gnn_tpu_torch -- the Fourier Sliced-Wasserstein GNN in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of `fsw_gnn_tpu` (JAX), one slice at a time; ROADMAP.md lists
what is ported.  It follows the JAX package's module layout and names.
Entry points run on the card unless given device='cpu'; on the CPU every
kernel is replaced by its plain PyTorch version.  This package imports no
JAX and nothing of `fsw_gnn_tpu`.
"""

from .bridge import (fswconv_from_jax, fswembedding_from_jax,
                     fswgnn_from_jax, fswgraphclassifier_from_jax,
                     fswreadout_from_jax)
from .conv import FlaxBatchNorm, FSWConv, FSWReadout
from .device import resolve_device
from .embedding import (FSWConfig, bucket_quadrature, fsw_embed_graph,
                        fsw_embed_graph_batched, fsw_embed_graph_dense,
                        fsw_embed_multi_table, fsw_embed_multiset,
                        fsw_embed_table, lowclamp)
from .graph import (Graph, MultiTable, NeighborTable, auto_layout,
                    degree_classes, from_edge_index, readout_graph,
                    stack_graphs, to_multi_table, to_neighbor_table)
from .models import FSWGNN, FSWGraphClassifier, gnn_layer_conv
from .modules import (FSWEmbedding, get_mutual_coherence,
                      spread_freqs_at_interval)
from .ops.coherence import minimize_mutual_coherence, mutual_coherence
from .ops.segment import (segment_argsort, segment_cumsum, segment_sort,
                          segment_sum)
from .params import (bias_shape, generate_freqs, generate_params,
                     generate_proj_vecs)
from .serving import (GraphServer, export_forward, export_from_checkpoint,
                      load_artifact, load_forward, multi_envelope,
                      save_artifact)
from .train import TrainConfig, Trainer
from .utils import dsmetric

__version__ = '0.4.0'
