"""dgnn: a GNN message-passing framework in JAX for NVIDIA GPUs.

Fused sparse aggregation (SDDMM -> edge-softmax -> SpMM, Gaussian-mixture
edge weighting, k-NN neighbor-max) for GAT / MoNet / EdgeConv, built on
JAX/XLA over degree-binned CSR layouts with recompute-based custom VJPs,
scaling over several GPUs via row-partitioned graph shards.

Capability reference: dgSPARSE/dgNN (see SURVEY.md).
"""

from .graph import Graph, build_graph
from . import ops
from . import models

__version__ = "0.1.0"

__all__ = ["Graph", "build_graph", "ops", "models", "__version__"]
