from .datasets import (NodeClassificationData, load, load_npz,
                       synthetic_planted_partition)
from .sampler import CSCGraph, NeighborSampler, SampledBatch
