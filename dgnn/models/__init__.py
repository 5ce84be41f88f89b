from .gat import GAT, GATConv
from .monet import GMMConv, MoNet
from .dgcnn import DGCNN, EdgeConv

__all__ = ["GAT", "GATConv", "GMMConv", "MoNet", "DGCNN", "EdgeConv"]
