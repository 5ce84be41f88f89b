"""Row-partitioned graph shards with static halo-exchange plans.

The reference is strictly single-GPU (SURVEY.md §2.6: no distributed code
exists); this module supplies the missing scaling axis:

- Destination rows are partitioned into `num_shards` contiguous, equal-size
  ranges of a padded node space (node p*C..(p+1)*C-1 live on shard p).
- Each shard stores its rows' edges with *remapped* source indices into an
  extended local space: [0, C) = locally-owned sources, C + q*Hmax + j =
  the j-th halo slot received from shard q.
- The halo plan is a static [P, P, Hmax] table: `send_ids[p, q]` lists the
  local indices shard p must send to shard q each layer (padded with 0).
  At runtime one `all_to_all` per layer moves exactly these rows
  (parallel/spmd.py), and XLA autodiff reverses it for gradients.
- Edges are split into a *local* bin set (sources owned locally) and a
  *halo* bin set, so the local partial aggregation overlaps with the
  all_to_all in XLA's schedule; the two partial results merge through the
  same log-sum-exp segment combine the single-chip op uses.

All shards share identical array shapes (padded to maxima), so they stack on
a leading mesh axis and drop into `shard_map` untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import binning as _binning
from ..graph import build as _build
from ..graph.structure import BinnedAdj, CombineTable

__all__ = ["GraphShards", "partition_graph"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GraphShards:
    """Stacked per-shard graph data; leading axis = shard (mesh axis).

    fwd_local / fwd_halo: binned adjacency over local destination rows, with
    sources in the extended local index space ([C local] ++ [P*Hmax halo]).
    bwd: binned transpose over extended source rows.
    send_ids[p, q, Hmax]: local row indices shard p sends to shard q.

    Each shard carries combine tables (fwd_cmb over local rows, bwd_cmb over
    the extended source space) covering local bins ++ halo bins — the
    sharded hot path runs the same combine-merge formulation as the
    single-chip op.
    ``ext_gids[p, i]`` maps extended local index i to the GLOBAL node id
    (locals are p*C+i; halo slots resolve through the peer's send list), so
    stateless pair-hash dropout keys on global ids and shard-vs-single masks
    match bit-for-bit (ops/common.py pair_keep).
    """

    fwd_local: BinnedAdj  # arrays stacked [P, ...]
    fwd_halo: BinnedAdj
    bwd: BinnedAdj
    send_ids: jax.Array  # [P, P, Hmax] int32
    edge_gids: jax.Array  # [P, Emax] int32 — global CSR edge id per local edge
    # (lets per-edge data such as GMM pseudo-coords reshard: parallel.spmd
    # .shard_edge_data)
    ext_gids: jax.Array  # [P, ext] int32 — global node id per extended index
    fwd_cmb: object  # CombineTable stacked [P, ...]
    bwd_cmb: object
    num_shards: int = dataclasses.field(metadata=dict(static=True))
    nodes_per_shard: int = dataclasses.field(metadata=dict(static=True))
    halo_max: int = dataclasses.field(metadata=dict(static=True))
    num_nodes: int = dataclasses.field(metadata=dict(static=True))  # unpadded

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.nodes_per_shard

    @property
    def ext_size(self) -> int:
        return self.nodes_per_shard + self.num_shards * self.halo_max


def _stack_binned(per_shard: Sequence[_binning.BinnedCSR], num_rows: int,
                  num_edges: int) -> BinnedAdj:
    """Stack per-shard BinnedCSR (same widths) padding segment counts."""
    widths = per_shard[0].widths
    assert all(b.widths == widths for b in per_shard)
    nbrs, edges, rows, counts = [], [], [], []
    for bi, w in enumerate(widths):
        smax = max(b.nbr[bi].shape[0] for b in per_shard)
        nb, eb, rb, cb = [], [], [], []
        for b in per_shard:
            s = b.nbr[bi].shape[0]
            pad = smax - s
            nb.append(np.pad(b.nbr[bi], ((0, pad), (0, 0))))
            eb.append(np.pad(b.edge[bi], ((0, pad), (0, 0))))
            rb.append(np.pad(b.row[bi], (0, pad)))
            cb.append(np.pad(b.count[bi], (0, pad)))
        nbrs.append(jnp.asarray(np.stack(nb)))
        edges.append(jnp.asarray(np.stack(eb)))
        rows.append(jnp.asarray(np.stack(rb)))
        counts.append(jnp.asarray(np.stack(cb)))
    return BinnedAdj(nbr=tuple(nbrs), edge=tuple(edges), row=tuple(rows),
                     epos=None, count=tuple(counts), cmb=None, widths=widths,
                     num_rows=num_rows, num_edges=num_edges)


def _bin_subset(row_ptr, col_ind, edge_ids, sel, num_rows, widths):
    """Bin only the edges selected by bool mask `sel`, keeping row ids."""
    keep = np.nonzero(sel)[0]
    csr_row = np.repeat(np.arange(num_rows, dtype=np.int64),
                        np.diff(row_ptr).astype(np.int64))
    rows = csr_row[keep]
    counts = np.bincount(rows, minlength=num_rows)
    new_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ptr[1:])
    return _binning.bin_csr(new_ptr, col_ind[keep].astype(np.int32),
                            edge_ids=edge_ids[keep], widths=widths,
                            keep_empty=True)


def _pad1(x, n, fill=0):
    x = np.asarray(x)
    if len(x) >= n:
        return x
    return np.concatenate([x, np.full(n - len(x), fill, x.dtype)])


def _shard_cmb(bin_sets: Sequence[_binning.BinnedCSR],
               targets: Sequence[Sequence[int]], num_rows: int):
    """Per-shard combine table over the op's partial order: every bin of
    every bin set in sequence (mirrors structure.from_binned).

    Positions must index the STACKED runtime layout, in which every bin is
    padded to the cross-shard max segment count (``targets``, matching
    _stack_binned) — pad segments enter the position numbering but are
    marked invalid."""
    rows, valid = [], []
    for bs, tgt in zip(bin_sets, targets):
        for bi in range(bs.num_bins):
            r = np.asarray(bs.row[bi], np.int64)
            v = np.asarray(bs.count[bi]) > 0
            pad = tgt[bi] - len(r)
            rows.append(np.concatenate([r, np.zeros(pad, np.int64)]))
            valid.append(np.concatenate([v, np.zeros(pad, bool)]))
    return _binning.combine_tables(np.concatenate(rows), num_rows,
                                   np.concatenate(valid))


def _stack_cmb(cmbs) -> CombineTable:
    """Stack per-shard (main, ov_rows, ov) combine tables, padding widths
    with -1 and the overflow list with idempotent entries: a pad overflow
    row re-merges a non-overflow row's exact main-table position list, so
    patching it in recomputes the value it already has."""
    km = max(m.shape[1] for m, _, _ in cmbs)
    vmax = max(len(r) for _, r, _ in cmbs)
    kov = max([o.shape[1] for _, _, o in cmbs if o.size] + [1])
    mains, rows_s, ovs = [], [], []
    for main, ov_rows, ov in cmbs:
        n, k = main.shape
        m = np.full((n, km), -1, np.int32)
        m[:, :k] = main
        mains.append(m)
        o = np.full((vmax, max(kov, km)), -1, np.int32)
        if ov.size:
            o[:len(ov_rows), :ov.shape[1]] = ov
        r = np.zeros(vmax, np.int32)
        r[:len(ov_rows)] = ov_rows
        if vmax > len(ov_rows):
            # idempotent padding: the smallest row NOT in ov_rows, with its
            # own main-table list (patch == what main already computed)
            in_ov = np.zeros(n, bool)
            in_ov[ov_rows] = True
            pad_row = int(np.nonzero(~in_ov)[0][0])
            r[len(ov_rows):] = pad_row
            o[len(ov_rows):, :km] = main[pad_row]
        rows_s.append(r)
        ovs.append(o)
    return CombineTable(main=jnp.asarray(np.stack(mains)),
                        ov_rows=jnp.asarray(np.stack(rows_s)),
                        ov=jnp.asarray(np.stack(ovs)))


def partition_graph(src, dst, num_nodes: int, num_shards: int, *,
                    widths: Sequence[int] | None = None,
                    self_loops: bool = True) -> GraphShards:
    """Build row-partitioned shards + halo plan from a COO edge list (host).

    ``widths=None`` derives bin widths per DIRECTION from the combined
    per-shard degree histograms (shards must share one width set so their
    bin tables stack on the mesh axis)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if self_loops:
        src, dst = _build.remove_self_loops(src, dst)
        src, dst = _build.add_self_loops(src, dst, num_nodes)
    c = -(-num_nodes // num_shards)  # nodes per shard (padded space)

    row_ptr, col_ind = _build.coo_to_csr(src, dst, num_nodes)
    if widths is not None:
        w_fwd = w_bwd = tuple(widths)
    else:
        w_fwd = w_bwd = None  # derived from the residual degrees below
    csr_row = np.repeat(np.arange(num_nodes, dtype=np.int64),
                        np.diff(row_ptr).astype(np.int64))
    owner_dst = csr_row // c
    owner_src = col_ind.astype(np.int64) // c

    # ---- halo plan (fully vectorized: one sort over the cross-shard edges,
    # not an O(P^2) pair loop with per-pair full-edge scans)
    s = num_shards
    npad = s * c
    cross = owner_dst != owner_src
    key = owner_dst * s + owner_src  # [E] (consumer, producer) pair id
    combo = key.astype(np.int64) * npad + col_ind.astype(np.int64)
    uniq = np.unique(combo[cross])  # sorted: pair-major, then source id
    ukey = uniq // npad
    usrc = uniq % npad
    pair_start = np.searchsorted(ukey, np.arange(s * s + 1))
    pair_cnt = np.diff(pair_start)
    h_max = max(int(pair_cnt.max(initial=0)), 1)

    send_ids = np.zeros((s, s, h_max), np.int32)
    slot = np.arange(len(uniq)) - pair_start[ukey]
    # consumer p = ukey // s needs usrc from producer q = ukey % s
    send_ids[ukey % s, ukey // s, slot] = (usrc - (ukey % s) * c).astype(
        np.int32)

    # remap every cross edge's source to its halo slot in one pass
    remapped_all = col_ind.astype(np.int64) - owner_src * c  # local default
    if cross.any():
        idx = np.searchsorted(uniq, combo[cross])
        pos = idx - pair_start[ukey[idx]]
        remapped_all[cross] = c + owner_src[cross] * h_max + pos

    # ---- per-shard binned layouts (CSR order is row-sorted, so each shard's
    # edges are one contiguous slice — no per-shard full-edge masks)
    ext = c + num_shards * h_max
    shard_lo = np.searchsorted(owner_dst, np.arange(num_shards + 1))

    # phase 1: per-shard local CSR over c rows and its transpose over the
    # extended source space
    fres, bres, gids_b = [], [], []
    for p in range(num_shards):
        e_sel = np.arange(shard_lo[p], shard_lo[p + 1])
        rows_l = (csr_row[e_sel] - p * c).astype(np.int64)
        is_local = ~cross[e_sel]
        remapped = remapped_all[e_sel]
        # rebuild a local CSR over c rows; local edge ids = order within shard
        order = np.lexsort((remapped, rows_l))
        rows_s = rows_l[order]
        cols_s = remapped[order].astype(np.int32)
        loc_s = is_local[order]
        counts = np.bincount(rows_s, minlength=c)
        lptr = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=lptr[1:])
        eids = np.arange(len(cols_s), dtype=np.int64)
        fres.append((lptr, cols_s, eids, loc_s))
        # transpose over extended sources for the backward pass
        order_t = np.lexsort((rows_s, cols_s))
        t_counts = np.bincount(cols_s, minlength=ext)
        tptr = np.zeros(ext + 1, np.int64)
        np.cumsum(t_counts, out=tptr[1:])
        bres.append((tptr, rows_s[order_t].astype(np.int32), eids[order_t]))
        gids_b.append(e_sel[order])  # global CSR edge id per local edge

    if w_fwd is None:
        w_fwd = _binning.auto_widths(
            np.concatenate([np.diff(r[0]) for r in fres]))
        w_bwd = _binning.auto_widths(
            np.concatenate([np.diff(r[0]) for r in bres]))

    # phase 2: bin every shard with the common widths
    fwd_local_b, fwd_halo_b, bwd_b = [], [], []
    fcmbs, bcmbs = [], []
    for p in range(num_shards):
        f_ptr, f_cols, f_eids, loc_res = fres[p]
        fwd_local_b.append(
            _bin_subset(f_ptr, f_cols, f_eids, loc_res, c, w_fwd))
        fwd_halo_b.append(
            _bin_subset(f_ptr, f_cols, f_eids, ~loc_res, c, w_fwd))
        b_ptr, b_cols, b_eids = bres[p]
        bwd_b.append(_binning.bin_csr(b_ptr, b_cols, edge_ids=b_eids,
                                      widths=w_bwd, keep_empty=True))

    # combine tables index the STACKED (cross-shard padded) partial layout
    def _targets(bsets):
        return [max(b.nbr[bi].shape[0] for b in bsets)
                for bi in range(bsets[0].num_bins)]

    tl, th, tb = (_targets(fwd_local_b), _targets(fwd_halo_b),
                  _targets(bwd_b))
    for p in range(num_shards):
        fcmbs.append(_shard_cmb([fwd_local_b[p], fwd_halo_b[p]], [tl, th], c))
        bcmbs.append(_shard_cmb([bwd_b[p]], [tb], ext))

    e_max = max(b.num_edges for b in fwd_local_b + fwd_halo_b)
    g_max = max(len(g) for g in gids_b)
    gids = np.zeros((num_shards, g_max), np.int32)
    for p, g in enumerate(gids_b):
        gids[p, : len(g)] = g
    # global node id per extended index: locals are p*c+i; halo slot
    # c + q*h_max + j resolves through shard q's send list to shard p
    ext_gids = np.zeros((num_shards, ext), np.int64)
    ext_gids[:, :c] = (np.arange(num_shards)[:, None] * c
                       + np.arange(c)[None, :])
    for p in range(num_shards):
        ext_gids[p, c:] = (np.arange(num_shards)[:, None] * c
                           + send_ids[:, p, :]).reshape(-1)
    return GraphShards(
        fwd_local=_stack_binned(fwd_local_b, c, e_max),
        fwd_halo=_stack_binned(fwd_halo_b, c, e_max),
        bwd=_stack_binned(bwd_b, ext, e_max),
        send_ids=jnp.asarray(send_ids),
        edge_gids=jnp.asarray(gids),
        ext_gids=jnp.asarray(ext_gids, jnp.int32),
        fwd_cmb=_stack_cmb(fcmbs),
        bwd_cmb=_stack_cmb(bcmbs),
        num_shards=num_shards,
        nodes_per_shard=c,
        halo_max=h_max,
        num_nodes=num_nodes,
    )
