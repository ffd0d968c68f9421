from .datasets import (NodeClassificationData, load, load_npz,
                       synthetic_planted_partition)
