from .synthetic import (
    synthetic_citation,
    synthetic_point_clouds,
    rmat_edges,
    CitationData,
)
from .loaders import load_citation_dataset, load_modelnet, load_node_task

__all__ = [
    "synthetic_citation",
    "synthetic_point_clouds",
    "rmat_edges",
    "CitationData",
    "load_citation_dataset",
    "load_modelnet",
    "load_node_task",
]
