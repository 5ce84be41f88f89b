"""Standalone sparse primitives over the binned graph layout.

The reference ships these as separate CUDA modules usable outside the three
fused layers: `mhsddmm` (src/sddmm/mhsddmm.cc), single-head `sddmm`
(src/sddmm/sddmm.cpp, dead code), `mhtranspose` (src/csr2csc/mhtranspose.cc)
and the SpMM embedded in every layer.  Here they are first-class functional
ops with memory-lean custom VJPs, sharing the binned machinery, so users can
compose new GNN layers beyond GAT/GMM/EdgeConv.  (These flat-edge-data APIs
need the graph built with device edge tables; the fused layers do not.)

Shapes: per-edge data is [E, H] (or [E, H, ...]) in CSR edge order; node
data [N, H, F].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..graph.structure import BinnedAdj, Graph
from .common import (chunk_rows_for_budget, float0_like, lane_mask,
                     scan_chunked)

__all__ = ["spmm", "sddmm", "edge_softmax", "edge_transpose"]


def _segment_sum(x, ids, n):
    return jax.ops.segment_sum(x, ids, num_segments=n)


def _spmm_adj(adj: BinnedAdj, weights, feat):
    """out[r, h, f] = sum_{e in row r} weights[e, h] * feat[col(e), h, f]."""
    h = weights.shape[-1]
    f = feat.shape[-1]
    accs, rows = [], []
    for width, nbr, edge, row, count in adj.bins():
        chunk = chunk_rows_for_budget(width, h * f)

        def fn(nbr_c, edge_c, count_c):
            m = lane_mask(count_c, width)
            w = jnp.where(m[..., None], weights[edge_c], 0.0)
            x = feat[nbr_c]
            return (jnp.einsum("swh,swhf->shf", w, x,
                               preferred_element_type=jnp.float32),), ()

        (acc,), _ = scan_chunked(fn, (nbr, edge, count), nbr.shape[0],
                                 chunk, ())
        accs.append(acc)
        rows.append(row)
    return _segment_sum(jnp.concatenate(accs), jnp.concatenate(rows),
                        adj.num_rows)


def _sddmm_adj(adj: BinnedAdj, lhs, rhs, num_edges):
    """w[e, h] = <lhs[row(e), h, :], rhs[col(e), h, :]> in flat CSR edge
    order.  Per-slot results are emitted in concatenated [S*W] slot order and
    re-ordered to CSR edge order by ONE edge-sized gather through the
    build-time inverse slot table ``adj.epos`` — never an edge-sized
    segment_sum scatter (reference analogue mhsddmm writes each edge's dot
    directly, mhsddmm_kernel.cu:11-99)."""
    assert adj.epos is not None, \
        "sddmm needs a graph built with edge_tables=True"
    h = lhs.shape[1]
    f = lhs.shape[-1]
    parts = []
    for width, nbr, edge, row, count in adj.bins():
        chunk = chunk_rows_for_budget(width, 2 * h * f)

        def fn(nbr_c, row_c, count_c):
            m = lane_mask(count_c, width)
            g = jnp.einsum("shf,swhf->swh", lhs[row_c], rhs[nbr_c],
                           preferred_element_type=jnp.float32)
            return (jnp.where(m[..., None], g, 0.0),), ()

        (g,), _ = scan_chunked(fn, (nbr, row, count), nbr.shape[0], chunk,
                               ())
        parts.append(g.reshape(-1, h))  # [S*W, h] slot order
    return jnp.concatenate(parts)[adj.epos]


# ---------------------------------------------------------------------------
# public ops with custom VJPs
# ---------------------------------------------------------------------------


@jax.custom_vjp
def _spmm(adj_fwd, adj_bwd, weights, feat):
    return _spmm_adj(adj_fwd, weights, feat)


def _spmm_fwd(adj_fwd, adj_bwd, weights, feat):
    return _spmm_adj(adj_fwd, weights, feat), (adj_fwd, adj_bwd, weights, feat)


def _spmm_bwd(res, g):
    adj_fwd, adj_bwd, weights, feat = res
    d_feat = _spmm_adj(adj_bwd, weights, g).astype(feat.dtype)
    d_w = _sddmm_adj(adj_fwd, g, feat, adj_fwd.num_edges).astype(weights.dtype)
    return (float0_like(adj_fwd), float0_like(adj_bwd), d_w, d_feat)


_spmm.defvjp(_spmm_fwd, _spmm_bwd)


def spmm(graph: Graph, edge_weights, feat):
    """out[v] = sum over in-edges e=(u->v) of edge_weights[e] * feat[u].

    edge_weights: [E, H] in CSR edge order; feat: [N, H, F] -> out [N, H, F].
    Reference analogue: the SpMM stage of every fused layer; backward uses
    the transposed binned layout and an SDDMM, like fused_gatconv's
    mhspmm/mhsddmm pair (fused_gatconv_kernel.cu:712-890)."""
    return _spmm(graph.fwd, graph.bwd, edge_weights, feat)


@jax.custom_vjp
def _sddmm(adj_fwd, adj_bwd, lhs, rhs):
    return _sddmm_adj(adj_fwd, lhs, rhs, adj_fwd.num_edges)


def _sddmm_fwd(adj_fwd, adj_bwd, lhs, rhs):
    return _sddmm(adj_fwd, adj_bwd, lhs, rhs), (adj_fwd, adj_bwd, lhs, rhs)


def _sddmm_bwd(res, g):
    adj_fwd, adj_bwd, lhs, rhs = res
    # d lhs[r] = sum_e g[e] * rhs[col(e)] : SpMM on the forward layout
    d_lhs = _spmm_adj(adj_fwd, g, rhs).astype(lhs.dtype)
    # d rhs[c] = sum_e g[e] * lhs[row(e)] : SpMM on the transposed layout
    d_rhs = _spmm_adj(adj_bwd, g, lhs).astype(rhs.dtype)
    return (float0_like(adj_fwd), float0_like(adj_bwd), d_lhs, d_rhs)


_sddmm.defvjp(_sddmm_fwd, _sddmm_bwd)


def sddmm(graph: Graph, lhs, rhs):
    """w[e] = <lhs[dst(e)], rhs[src(e)]> per head, e in CSR order.

    lhs/rhs: [N, H, F] -> [E, H].  Reference analogue: mhsddmm
    (mhsddmm_kernel.cu:11-99); single-head is H=1."""
    return _sddmm(graph.fwd, graph.bwd, lhs, rhs)


def edge_softmax(graph: Graph, scores):
    """Numerically-safe softmax of per-edge scores over each destination's
    in-edges (reference analogue: the edge-softmax stage inside
    fused_forward_kernel; DGL's edge_softmax).

    scores: [E, H] CSR order -> [E, H] normalized. Differentiable via the
    segment ops (memory O(E*H), no feature traffic)."""
    h = scores.shape[-1]
    n = graph.num_nodes
    e = graph.num_edges
    row = jnp.repeat(jnp.arange(n, dtype=jnp.int32), jnp.diff(graph.row_ptr),
                     total_repeat_length=e)
    m = jax.ops.segment_max(scores, row, num_segments=n)
    m = jnp.where(jnp.isneginf(m), 0.0, m)
    w = jnp.exp(scores - m[row])
    l = _segment_sum(w, row, n)
    return w / jnp.maximum(l, 1e-20)[row]


def edge_transpose(graph: Graph, edge_data):
    """Re-index per-edge data from CSR order to CSC (transposed) order
    (reference analogue: mhtranspose, mhtranspose_kernel.cu:16-47)."""
    return edge_data[graph.permute]
