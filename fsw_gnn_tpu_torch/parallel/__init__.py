"""The distributed paths on torch.distributed, one process per device:
edge partitioning, the boundary exchanges, the edge-partitioned full-graph
step and forward, data-parallel minibatch steps, and a local launcher."""
from .partition import (GraphShards, local_graph, partition_graph,
                        shard_node_features, shard_recipient_labels,
                        unshard_recipient_values)
from .dist import (make_distributed_forward, make_distributed_train_step,
                   masked_softmax_cross_entropy)
from .dp import make_dp_train_step, stack_batches
from .runtime import (Mesh, ensure_distributed, global_mesh, make_data_mesh,
                      make_graph_mesh)
