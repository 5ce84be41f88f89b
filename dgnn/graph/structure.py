"""Device-side graph containers (JAX pytrees).

The reference passes five raw index tensors positionally through every layer
(`GATConv.forward(row_ptr, col_ind, col_ptr, row_ind, permute, feat)`,
reference layers/gatconv_layer.py:69).  Here the graph is a single immutable
pytree that jits/shards cleanly: raw CSR/CSC for generic use plus the binned
layouts (see binning.py) that every fused op consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import binning as _binning
from . import build as _build

__all__ = ["BinnedAdj", "CombineTable", "Graph", "build_graph",
           "build_graph_from_csr", "from_binned"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CombineTable:
    """Scatter-free segment-merge structure (binning.combine_tables).

    ``main`` is the [N, Km] position table covering all rows with <= Km
    partials (Km is capped at the ~99.9th-percentile segment count, not the
    max — the merge gather pays Km gathered rows per graph row, so one
    9-segment mega-row must not widen every row's gather).  The few rows
    with more partials are -1 in ``main``; their full lists live in the
    [V, K] ``ov`` table, merged separately and patched in by row id."""

    main: jax.Array     # [N, Km] int32 positions, -1 padded
    ov_rows: jax.Array  # [V] int32 overflow row ids (V ~ 0)
    ov: jax.Array       # [V, K] int32 positions, -1 padded


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BinnedAdj:
    """Degree-binned adjacency on device. See binning.BinnedCSR.

    ``cmb``: optional [num_rows, K] combine table (binning.combine_table) —
    per row, the positions of its segment partials in the concatenated
    per-bin order (-1 padded).  When present, ops merge per-segment partials
    (the segments of split mega-rows) with an [N, K] gather instead of
    segment_sum/segment_max."""

    nbr: tuple  # per bin: [S_b, W_b] int32
    edge: tuple  # per bin: [S_b, W_b] int32 (global CSR edge id), or Nones
    row: tuple  # per bin: [S_b] int32
    count: tuple  # per bin: [S_b] int32
    cmb: object  # [num_rows, K] int32 combine table, or None
    # [num_edges] int32 slot position of each CSR edge in the concatenated
    # per-bin [S*W] slot order, or None.  Built with the edge tables; lets
    # per-edge outputs (sddmm) emit in slot order and land in CSR order via
    # ONE edge-sized gather instead of a segment_sum scatter.
    epos: object
    widths: tuple = dataclasses.field(metadata=dict(static=True))
    num_rows: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_bins(self) -> int:
        return len(self.widths)

    def bins(self):
        """Iterate (width, nbr, edge, row, count) per bin."""
        for b in range(self.num_bins):
            yield self.widths[b], self.nbr[b], self.edge[b], self.row[b], self.count[b]


def from_binned(b: _binning.BinnedCSR, with_cmb: bool = True,
                with_edge: bool = True) -> BinnedAdj:
    """Upload a host BinnedCSR to device.

    ``with_edge=False`` omits the per-slot global-edge-id tables AND the
    inverse slot-position table ``epos`` (only needed by flat per-edge data
    APIs such as ops.primitives.spmm/sddmm — the fused layers derive
    everything from (row, nbr) ids)."""
    cmb = None
    epos = None
    if with_edge:
        # inverse permutation: CSR edge id -> position in the concatenated
        # [S*W] slot order (one host-side scatter, once per graph) — lets
        # sddmm-like ops emit per-slot results and produce CSR edge order
        # with ONE gather instead of an edge-sized segment_sum.
        ep = np.full(b.num_edges, 0, np.int64)
        off = 0
        for bi in range(len(b.nbr)):
            e_t = np.asarray(b.edge[bi], np.int64)
            s, w = e_t.shape
            m = (np.arange(w)[None, :]
                 < np.asarray(b.count[bi])[:, None])
            pos = off + np.arange(s * w, dtype=np.int64).reshape(s, w)
            ep[e_t[m]] = pos[m]
            off += s * w
        assert off <= np.iinfo(np.int32).max, (
            f"padded slot count {off} overflows the int32 epos table")
        epos = jnp.asarray(ep, jnp.int32)
    if with_cmb:
        rows_concat = [np.asarray(r) for r in b.row]
        valid = [np.asarray(c) > 0 for c in b.count]
        main, ov_rows, ov = _binning.combine_tables(
            np.concatenate(rows_concat), b.num_rows, np.concatenate(valid))
        cmb = CombineTable(main=jnp.asarray(main),
                           ov_rows=jnp.asarray(ov_rows),
                           ov=jnp.asarray(ov))
    return BinnedAdj(
        nbr=tuple(jnp.asarray(x) for x in b.nbr),
        edge=(tuple(jnp.asarray(x) for x in b.edge) if with_edge
              else (None,) * len(b.nbr)),
        row=tuple(jnp.asarray(x) for x in b.row),
        count=tuple(jnp.asarray(x) for x in b.count),
        cmb=cmb,
        epos=epos,
        widths=b.widths,
        num_rows=b.num_rows,
        num_edges=b.num_edges,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-topology graph: CSR over destination rows (aggregation reads
    row i's in-neighbors), CSC transpose, the CSR->CSC edge permutation, and
    both binned layouts.  All indices int32 (reference asserts the same,
    fused_gatconv.cpp:146-160)."""

    row_ptr: jax.Array  # [N+1] int32
    col_ind: jax.Array  # [E]   int32 — source node of CSR edge e
    col_ptr: jax.Array  # [N+1] int32
    row_ind: jax.Array  # [E]   int32 — destination node of CSC slot j
    permute: jax.Array  # [E]   int32 — CSR edge id stored at CSC slot j
    fwd: BinnedAdj  # binned CSR: rows = destinations, slots = sources
    bwd: BinnedAdj  # binned CSC: rows = sources, slots = destinations
    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))

    def in_degrees(self) -> jax.Array:
        return jnp.diff(self.row_ptr)

    def out_degrees(self) -> jax.Array:
        return jnp.diff(self.col_ptr)

    def slim(self) -> "Graph":
        """Graph with the raw CSR/CSC/permute arrays dropped (zero-length).

        The fused ops consume only the binned layouts; the raw arrays (~12
        bytes/edge — 1.4 GB at Reddit scale) are preprocessing outputs that
        should not ride along into jit arguments / device memory.  Use the
        full graph for setup (degrees, pseudo binning), then pass
        ``graph.slim()`` into training steps."""
        empty = jnp.zeros((0,), jnp.int32)
        return dataclasses.replace(self, row_ptr=empty, col_ind=empty,
                                   col_ptr=empty, row_ind=empty,
                                   permute=empty)


def build_graph(
    src,
    dst,
    num_nodes: int,
    *,
    widths: Sequence[int] | None = None,
    self_loops: bool = True,
    edge_tables: bool = True,
) -> Graph:
    """Host-side one-time preprocessing from a COO edge list (edge u->v means
    v aggregates u), mirroring the reference pipeline
    (train_gatconv.py:75-94) with degree binning added.

    ``widths=None`` picks bin widths per direction from the degree histogram
    (binning.auto_widths) — padding in the slot tables is directly wasted
    gather time, so the widths minimize total padded slots.

    ``edge_tables=False`` omits the per-slot global-edge-id device tables
    (~4 bytes/slot/direction) — only the flat per-edge-data APIs
    (ops.primitives, ops.gmm.gmm_aggregate) need them."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if self_loops:
        src, dst = _build.remove_self_loops(src, dst)
        src, dst = _build.add_self_loops(src, dst, num_nodes)
    row_ptr, col_ind = _build.coo_to_csr(src, dst, num_nodes)
    col_ptr, row_ind, permute = _build.csr_to_csc_permute(row_ptr, col_ind)
    return build_graph_from_csr(row_ptr, col_ind, col_ptr, row_ind, permute,
                                widths=widths, edge_tables=edge_tables)


def build_graph_from_csr(
    row_ptr,
    col_ind,
    col_ptr,
    row_ind,
    permute,
    *,
    widths: Sequence[int] | None = None,
    edge_tables: bool = True,
) -> Graph:
    """build_graph from already-preprocessed CSR/CSC/permute arrays (e.g. a
    raw-array disk cache — the expensive sorts are layout-independent and
    cached separately from the binned layout, graph/cache.rmat_graph)."""
    row_ptr = np.asarray(row_ptr, np.int64)
    col_ind = np.asarray(col_ind)
    col_ptr = np.asarray(col_ptr, np.int64)
    row_ind = np.asarray(row_ind)
    permute = np.asarray(permute)
    num_nodes = len(row_ptr) - 1

    def _one_dir(rp, ci, eids):
        w = widths if widths is not None else _binning.auto_widths(
            np.diff(rp))
        binned = _binning.bin_csr(rp, ci, edge_ids=eids, widths=w)
        return from_binned(binned, with_edge=edge_tables)

    fwd = _one_dir(row_ptr, col_ind, None)
    bwd = _one_dir(col_ptr, row_ind, permute)
    return Graph(
        row_ptr=jnp.asarray(row_ptr, dtype=jnp.int32),
        col_ind=jnp.asarray(col_ind),
        col_ptr=jnp.asarray(col_ptr, dtype=jnp.int32),
        row_ind=jnp.asarray(row_ind),
        permute=jnp.asarray(permute),
        fwd=fwd,
        bwd=bwd,
        num_nodes=int(num_nodes),
        num_edges=int(col_ind.shape[0]),
    )
