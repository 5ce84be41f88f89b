"""Naive (materializing) baselines: what DGL/PyG-style frameworks do.

The reference's perf tier compares its fused kernels against DGL/PyG
implementations of the same models (test/perf_test/, SURVEY.md §4).  This is
the JAX equivalent of their execution strategy: materialize per-edge score,
softmax and message tensors ([E, H], [E, H, F]) in device memory and reduce
with segment ops.  It is also the plain reference the fused binned ops are
checked against at real widths (chip_smoke.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..graph.structure import Graph
from .common import leaky_relu, pair_keep

__all__ = ["gat_naive", "gmm_naive"]


def _edge_rows(graph: Graph):
    return jnp.repeat(jnp.arange(graph.num_nodes, dtype=jnp.int32),
                      jnp.diff(graph.row_ptr),
                      total_repeat_length=graph.num_edges)


def gat_naive(graph: Graph, attn_row, attn_col, feat, *,
              negative_slope: float = 0.2, attn_drop: float = 0.0,
              key=None, training: bool = False):
    """Edge-materializing GAT aggregation (DGL edge_softmax + update_all
    analogue).  Autodiff saves the [E, H, F] message tensor — the memory
    blow-up the fused op avoids (dgNN's 8.3 GB vs DGL's 22.5 GB on Reddit,
    SURVEY.md §2.2)."""
    row = _edge_rows(graph)
    col = graph.col_ind
    n = graph.num_nodes
    s = leaky_relu(attn_row[row] + attn_col[col], negative_slope)  # [E, H]
    m = jax.ops.segment_max(s, row, num_segments=n)
    m = jnp.where(jnp.isneginf(m), 0.0, m)
    w = jnp.exp(s - m[row])
    l = jax.ops.segment_sum(w, row, num_segments=n)
    a = w / jnp.maximum(l, 1e-20)[row]
    if training and attn_drop > 0.0:
        seed = jax.random.bits(key, dtype=jnp.uint32)
        a = a * pair_keep(seed, row, col, attn_row.shape[1], attn_drop)
    msg = a[..., None] * feat[col]  # [E, H, F] materialized
    return jax.ops.segment_sum(msg, row, num_segments=n)


def gmm_naive(graph: Graph, feat, pseudo, mu, inv_sigma):
    """Edge-materializing MoNet aggregation."""
    from .gmm import gaussian_weights

    row = _edge_rows(graph)
    col = graph.col_ind
    w = gaussian_weights(pseudo, mu, inv_sigma)  # [E, K]
    msg = w[..., None] * feat[col]  # [E, K, F]
    return jax.ops.segment_sum(msg, row, num_segments=graph.num_nodes)
