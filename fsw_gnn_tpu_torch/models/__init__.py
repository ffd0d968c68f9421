from .gnn import FSWGNN, gnn_layer_conv
