from .gnn import FSWGNN, FSWGraphClassifier, gnn_layer_conv
