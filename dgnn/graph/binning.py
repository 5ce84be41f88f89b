"""Degree-aware row binning: the static-shape answer to dgNN's warp-per-row
traversal and tile-balance scheduling.

The reference walks CSR rows with one warp each, streaming edges in 32-wide
chunks, and fixes load imbalance with a host-side tile scheduler emitting
(rid, tile) pairs (reference: fused_gatconv_kernel.cu:24-118, 1082-1272;
script/test/test_gat_tb.py:16-26).  XLA wants static shapes, so we make the
tiles *static* instead: rows are grouped into bins by
degree, each bin is a dense, padded ``[segments, width]`` table of neighbor
ids, and rows longer than the widest bin are split into multiple segments
whose partial (max, sum, acc) results are merged with a flash-attention-style
log-sum-exp combine.  Every downstream kernel then sees only dense,
statically-shaped blocks.

All construction is vectorized numpy and runs once per graph on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["BinnedCSR", "bin_csr", "auto_widths", "DEFAULT_WIDTHS"]

# Widths cover mean degrees from citation graphs (~4) to Reddit (~500).
# The widest bin also serves as the split width for mega-rows.
DEFAULT_WIDTHS = (8, 32, 128, 512)

# ~1.4x geometric grid: powers of two and 3*2^k, up to 128K
_WIDTH_CANDIDATES = tuple(sorted(
    [2 ** k for k in range(2, 18)] + [3 * 2 ** k for k in range(2, 16)]))

# Fixed cost of an extra bin per pass, in gather slots: an extra bin must
# save at least this much padding to pay for itself.  Tuned on earlier
# hardware; re-tuning on the GPU is open (ROADMAP).
_BIN_PENALTY_SLOTS = 12288


def auto_widths(deg, max_bins: int = 8, candidates=_WIDTH_CANDIDATES,
                bin_penalty: int = _BIN_PENALTY_SLOTS,
                max_segs_per_row: int = 8) -> tuple:
    """Pick bin widths minimizing total padded slots for this degree
    distribution (every padded slot is a wasted gathered row).  Cost model
    per bin: each slot is one gathered row, each SEGMENT one resident-row
    fetch (splitting is not free), plus ``bin_penalty`` slots of fixed op
    overhead per extra bin, plus the MERGE cost of the top width: segment
    partials combine through an [N, Km] gather (combine_tables), so every
    unit of Km — set by the ~99.9th-percentile segments-per-row under the
    top width — costs N gathered rows per pass.

    Constraint: the largest width must satisfy ceil(dmax/wmax) <=
    ``max_segs_per_row`` — segments-per-row bounds the [N, K] combine-table
    width (binning.combine_table) and the size of all per-segment partial
    arrays; an unconstrained optimum at Reddit scale picked wmax=32 for an
    816k-degree hub, a 25,520-column combine table (~95 GB)."""
    import itertools

    deg = np.asarray(deg)
    n_all = int(deg.size)  # the combine table covers every row
    deg = deg[deg > 0]
    if deg.size == 0:
        return (candidates[0],)
    dmax = int(deg.max())
    cands = [int(w) for w in sorted(set(candidates))]
    cover = [w for w in cands if w >= dmax]
    if cover:  # drop widths beyond the smallest one covering dmax
        cands = [w for w in cands if w <= cover[0]]
    wmax_min = -(-dmax // max_segs_per_row)  # smallest admissible top width
    if not any(w >= wmax_min for w in cands):
        cands.append(int(2 ** np.ceil(np.log2(wmax_min))))
    nc = len(cands)

    # per-candidate stats
    n_le = np.array([np.count_nonzero(deg <= w) for w in cands], np.int64)
    # top_cost[i][j]: cost of a top (split) bin of width cands[j] covering
    # all rows with deg > cands[i] (i = -1 -> all rows)
    sorted_deg = np.sort(deg)
    def top_cost(lo_i, j):
        w = cands[j]
        lo = cands[lo_i] if lo_i >= 0 else 0
        rows = sorted_deg[np.searchsorted(sorted_deg, lo, side="right"):]
        if rows.size == 0:
            return 0
        nseg = int(np.sum(-(-rows // w)))
        return nseg * (w + 1)

    # merge cost of top width j: N * Km, Km = the capped combine width
    # (smallest c whose over-c rows fit the combine_tables overflow list)
    max_ov = max(64, n_all // 1000)
    merge_cost = np.empty(nc, np.int64)
    for j in range(nc):
        km = -(-dmax // cands[j])
        for c in range(1, km):
            over = deg.size - np.searchsorted(sorted_deg, c * cands[j],
                                              side="right")
            if over <= max_ov:
                km = c
                break
        merge_cost[j] = n_all * km

    # interval DP over increasing inner widths: dp[j][r] = min cost of r
    # inner bins whose largest is cands[j] (covering all deg <= cands[j])
    inner = np.empty((nc + 1, nc), np.int64)  # inner[i+1][j]: (cands_i, cands_j]
    for j in range(nc):
        for i in range(-1, j):
            cnt = n_le[j] - (n_le[i] if i >= 0 else 0)
            inner[i + 1][j] = cnt * (cands[j] + 1)

    INF = 1 << 62
    max_r = min(max_bins - 1, nc)
    dp = np.full((nc, max_r + 1), INF, np.int64)
    par = np.full((nc, max_r + 1), -2, np.int64)
    for j in range(nc):
        dp[j][1] = inner[0][j]
        par[j][1] = -1
    for r in range(2, max_r + 1):
        for j in range(nc):
            for i in range(j):
                if dp[i][r - 1] < INF:
                    c = dp[i][r - 1] + inner[i + 1][j]
                    if c < dp[j][r]:
                        dp[j][r] = c
                        par[j][r] = i

    best, best_cost = None, None
    for j in range(nc):  # top (split) bin
        if -(-dmax // cands[j]) > max_segs_per_row:
            continue
        # top bin alone
        c = top_cost(-1, j) + merge_cost[j]
        if best_cost is None or c < best_cost:
            best, best_cost = [j], c
        for i in range(j):  # inner bins end at cands[i]
            for r in range(1, max_r + 1):
                if dp[i][r] >= INF:
                    continue
                c = (dp[i][r] + top_cost(i, j) + r * bin_penalty
                     + merge_cost[j])
                if c < best_cost:
                    # reconstruct inner chain
                    chain, jj, rr = [], i, r
                    while jj >= 0:
                        chain.append(jj)
                        jj = int(par[jj][rr])
                        rr -= 1
                    best = list(reversed(chain)) + [j]
                    best_cost = c
    return tuple(cands[j] for j in best)


def combine_table(rows_concat: np.ndarray, num_rows: int,
                  valid: np.ndarray | None = None) -> np.ndarray:
    """[R, K] int32 positions of each row's segment partials in the
    concatenated per-bin order (-1 padded); K = max segments per row.

    This is the scatter-free merge structure: after the per-bin passes
    produce per-segment partials (m, l, acc, ...) concatenated across bins,
    each graph row's result is a masked reduction over its K gathered
    partials — an [R, K] GATHER, never a segment_sum/scatter.

    ``valid`` masks out the _SEG_PAD padding segments (count == 0) so they
    never enter any row's list."""
    rows_concat = np.asarray(rows_concat, dtype=np.int64)
    pos = np.arange(rows_concat.shape[0], dtype=np.int64)
    if valid is not None:
        keep = np.asarray(valid).astype(bool)
        rows_concat = rows_concat[keep]
        pos = pos[keep]
    counts = np.bincount(rows_concat, minlength=num_rows)
    k = max(int(counts.max(initial=0)), 1)
    tbl = np.full((num_rows, k), -1, np.int32)
    order = np.argsort(rows_concat, kind="stable")
    sorted_rows = rows_concat[order]
    # position within each row's group
    first = np.zeros(num_rows + 1, np.int64)
    np.cumsum(counts, out=first[1:])
    slot = np.arange(len(order), dtype=np.int64) - first[sorted_rows]
    tbl[sorted_rows, slot] = pos[order].astype(np.int32)
    return tbl


def combine_tables(rows_concat: np.ndarray, num_rows: int,
                   valid: np.ndarray | None = None):
    """Capped-width combine table + tiny overflow table.

    The [R, K]-gather merge pays K gathered rows for EVERY row, but K is set
    by the single worst row (a split mega-row can have 8+ segments while
    ~99.9% of rows have 1-2): on the Reddit-scale R-MAT the full table is
    [233k, 9] while all but 19 rows fit K=2 — 4.5x the necessary gathered
    rows on every merge.  Returns ``(main [R, Km], ov_rows [V],
    ov [V, K])``: ``main`` holds rows with <= Km partials (Km = smallest
    width covering all but <=0.1% of rows); the V overflow rows have -1s in
    ``main`` and their full lists in ``ov`` (merged separately — V is tiny).
    """
    tbl = combine_table(rows_concat, num_rows, valid)
    k = tbl.shape[1]
    counts = (tbl >= 0).sum(axis=1)
    max_ov = max(64, num_rows // 1000)
    km = k
    for cand in range(1, k):
        if int((counts > cand).sum()) <= max_ov:
            km = cand
            break
    ov_rows = np.nonzero(counts > km)[0].astype(np.int32)
    ov = tbl[ov_rows]
    main = tbl[:, :km].copy()
    main[ov_rows] = -1
    return main, ov_rows, ov


# Segments per bin are padded to a multiple of this.
_SEG_PAD = 8


@dataclasses.dataclass(frozen=True)
class BinnedCSR:
    """One direction of a binned adjacency (numpy, host-side).

    Per bin ``b`` (all padded with zeros where ``slot >= count``):
      nbr[b]   : [S_b, W_b] int32 — neighbor node id per slot
      edge[b]  : [S_b, W_b] int32 — *global CSR edge id* per slot (so per-edge
                 data such as dropout masks and pseudo-coords index
                 identically in forward (CSR) and transposed (CSC) layouts;
                 reference analogue: the `permute` array)
      row[b]   : [S_b] int32 — original row id of the segment
      count[b] : [S_b] int32 — number of valid slots in the segment
    """

    nbr: tuple
    edge: tuple
    row: tuple
    count: tuple
    widths: tuple
    num_rows: int
    num_edges: int

    @property
    def num_bins(self) -> int:
        return len(self.widths)

    def padded_slots(self) -> int:
        return int(sum(n.size for n in self.nbr))

    def fill_ratio(self) -> float:
        slots = self.padded_slots()
        return self.num_edges / slots if slots else 1.0


def _native():
    try:
        from .. import native
        return native if native.available() else None
    except Exception:
        return None


def _build_bin(
    row_ptr: np.ndarray,
    col_ind: np.ndarray,
    edge_ids: np.ndarray,
    rows: np.ndarray,
    starts: np.ndarray,
    counts: np.ndarray,
    width: int,
):
    """Materialize the dense [S, width] slot table for the given segments."""
    num_seg = rows.shape[0]
    pad = (-num_seg) % _SEG_PAD
    if pad:
        rows = np.concatenate([rows, np.zeros(pad, np.int64)])
        starts = np.concatenate([starts, np.zeros(pad, np.int64)])
        counts = np.concatenate([counts, np.zeros(pad, np.int64)])
    nat = _native()
    if nat is not None:
        nbr, edge = nat.bin_fill(starts, counts, width, col_ind, edge_ids)
    else:
        lane = np.arange(width, dtype=np.int64)[None, :]
        mask = lane < counts[:, None]
        offs = np.where(mask, starts[:, None] + lane, 0)
        nbr = np.where(mask, col_ind[offs], 0).astype(np.int32)
        edge = np.where(mask, edge_ids[offs], 0).astype(np.int32)
    return nbr, edge, rows.astype(np.int32), counts.astype(np.int32)


def bin_csr(
    row_ptr: np.ndarray,
    col_ind: np.ndarray,
    edge_ids: np.ndarray | None = None,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    keep_empty: bool = False,
) -> BinnedCSR:
    """Bin a CSR adjacency by row degree into padded fixed-width tables.

    ``edge_ids[j]`` gives the global edge id of CSR slot ``j`` (identity for
    the forward graph; the `permute` array for the transposed graph).
    ``keep_empty`` keeps zero-row bins so multiple graphs binned with the
    same widths produce structurally identical pytrees (needed when shards
    stack on a mesh axis).
    """
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    num_rows = row_ptr.shape[0] - 1
    num_edges = col_ind.shape[0]
    if edge_ids is None:
        edge_ids = np.arange(num_edges, dtype=np.int64)
    else:
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
    deg = np.diff(row_ptr)

    widths = tuple(sorted(set(int(w) for w in widths)))
    if not widths:
        raise ValueError("need at least one bin width")

    nbr_b, edge_b, row_b, count_b, used_widths = [], [], [], [], []
    lo = 0
    wmax = widths[-1]
    for w in widths:
        if w == wmax:
            sel = np.nonzero(deg > lo)[0]  # includes mega-rows, split below
        else:
            sel = np.nonzero((deg > lo) & (deg <= w))[0]
        lo = w
        if sel.size == 0:
            if keep_empty:
                nbr_b.append(np.zeros((_SEG_PAD, w), np.int32))
                edge_b.append(np.zeros((_SEG_PAD, w), np.int32))
                row_b.append(np.zeros(_SEG_PAD, np.int32))
                count_b.append(np.zeros(_SEG_PAD, np.int32))
                used_widths.append(w)
            continue
        d = deg[sel]
        if w == wmax:
            nseg = -(-d // w)  # ceil
            rows = np.repeat(sel, nseg)
            # segment index within its row
            first = np.cumsum(nseg) - nseg
            seg_i = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(first, nseg)
            starts = row_ptr[rows] + seg_i * w
            counts = np.minimum(w, deg[rows] - seg_i * w)
        else:
            rows, starts, counts = sel, row_ptr[sel], d
        n, e, r, c = _build_bin(row_ptr, col_ind, edge_ids, rows, starts, counts, w)
        nbr_b.append(n)
        edge_b.append(e)
        row_b.append(r)
        count_b.append(c)
        used_widths.append(w)

    if not used_widths:  # empty graph: emit one empty bin for shape stability
        w = widths[0]
        nbr_b = [np.zeros((_SEG_PAD, w), np.int32)]
        edge_b = [np.zeros((_SEG_PAD, w), np.int32)]
        row_b = [np.zeros(_SEG_PAD, np.int32)]
        count_b = [np.zeros(_SEG_PAD, np.int32)]
        used_widths = [w]

    return BinnedCSR(
        nbr=tuple(nbr_b),
        edge=tuple(edge_b),
        row=tuple(row_b),
        count=tuple(count_b),
        widths=tuple(used_widths),
        num_rows=num_rows,
        num_edges=num_edges,
    )
