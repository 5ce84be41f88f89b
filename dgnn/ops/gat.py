"""Fused multi-head GAT aggregation: SDDMM-score -> edge-softmax -> SpMM.

A re-design in JAX/XLA of the reference's `fused_gatconv` kernel family
(fused_gatconv_kernel.cu:24-118 forward, :712-1038 backward).  Shape of the
design:

- The graph is pre-binned by degree into dense [segments, width] slot tables
  (graph/binning.py); each bin is processed as statically-shaped gathers +
  einsums that XLA fuses, chunked under `lax.scan` to bound peak memory.
- Softmax is computed online per segment (max, sum-exp, weighted acc) and
  segments of split mega-rows are merged with a log-sum-exp combine — the
  same streaming-softmax structure as the reference's 3-pass warp kernel and
  its tile-balanced variant, but deterministic and atomics-free.
- Per-edge random access dominates the cost, so the whole op is
  organised as exactly TWO edge-sized gather passes per training step — the
  provable minimum (forward must touch x[src] per edge, backward must touch
  grad_out[dst] per edge) — with zero edge-sized scatters or permutes:
    pass A (fwd, CSR bins):  gather [x | attn_col] -> online softmax -> out,
                             plus the sign-split aggregate out_pos =
                             sum_{s>=0} a^ x and ratio r = sum_{s>=0} a
    pass B (bwd, CSC bins):  gather [grad_out | attn_row | M | L | ws];
                             per-SRC sums give dX and d attn_col in-pass
  The entire per-DESTINATION half of softmax backward collapses into
  closed-form node-local algebra over pass-A residuals — no third pass:
      ws_i = sum_j a^_ij <g_i, x_j>            = <g_i, out_i>
      t1_i = sum_j a^ <g,x> d_ij               = <g_i, slope*out_i
                                                  + (1-slope)*out_pos_i>
      t2_i = sum_j a_ij d_ij                   = slope + (1-slope)*r_i
      d attn_row = t1 - ws * t2
  using d = LeakyReLU' in {slope, 1} so sum_j (.)*d = slope*sum_j (.) +
  (1-slope)*sum_{s>=0} (.).  Every node-scalar operand pass B needs is
  CONCATENATED into the gathered row (ops/common.py pack_rows: one gather
  per slot instead of one per operand); the per-dst ws consumed on the src
  side rides the same trick.  The reference instead runs 3 backward kernels
  with an atomicAdd for grad_attn_col (fused_gatconv_kernel.cu:957).
- Backward is a `jax.custom_vjp` that saves only the per-row softmax stats
  (edge_max, edge_sum) [N, H] and *recomputes* per-edge attention, exactly
  the reference's memory-saving trade (SURVEY.md §2.2 invariant 1).
- Attention dropout is re-derived from (seed, dst id, src id, head) with a
  stateless hash (ops/common.py pair_keep), identical in every layout with
  ZERO per-edge state — the reference materializes a curand [nnz, h] mask
  and re-indexes it through `permute` instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..graph.structure import BinnedAdj, Graph
from .common import (
    NEG_INF,
    chunk_rows_for_budget,
    combine_lse,
    combine_sum,
    float0_like,
    lane_mask,
    leaky_relu,
    leaky_relu_grad,
    pack_rows,
    pair_keep,
    scan_chunked,
    unpack_scalars,
)

__all__ = ["gat_aggregate"]


def _segment_sum(x, ids, n):
    return jax.ops.segment_sum(x, ids, num_segments=n)


def _recompute_attn(mask, s, M_rows, Linv_rows):
    """Per-slot softmax weight a_e = exp(s - M_row) * Linv_row, masked.
    Linv = 1/max(L, eps) is precomputed once per destination (a multiply
    per slot instead of a divide)."""
    a = jnp.exp(s - M_rows) * Linv_rows
    return jnp.where(mask[..., None], a, 0.0)


# ---------------------------------------------------------------------------
# Forward (pass A)
# ---------------------------------------------------------------------------


def _forward_bin(width, nbr, row, count, ar, ac, feat, xcat, slope, p,
                 seed, training, with_pos=True, gid=None):
    """Per-bin streaming pass: per-segment (max, sumexp, weighted acc) plus —
    when ``with_pos`` (training) — the sign-split partials (sum-exp and
    weighted acc restricted to edges with score >= 0) that make softmax
    backward's per-destination half node-local (see module docstring).

    ``gid`` (optional [num_src_ids] int32): translation from the adjacency's
    id space to GLOBAL node ids for the dropout hash — graph shards index
    sources in a local+halo space, and keying pair_keep on global ids makes
    the sharded mask bit-identical to single-chip (parallel/partition.py
    ext_gids).  Costs one extra [S, W] gather, only when dropout is on."""
    H = ar.shape[-1]
    F = feat.shape[-1]
    chunk = chunk_rows_for_budget(width, H * F + H)

    def fn(nbr_c, row_c, count_c):
        mask = lane_mask(count_c, width)  # [S, W]
        g = xcat[nbr_c]  # [S, W, HF+H] — the ONE edge-sized gather
        x = g[..., :H * F].reshape(g.shape[0], width, H, F)
        ac_j = unpack_scalars(g, H * F)
        s = leaky_relu(ar[row_c][:, None, :] + ac_j, slope)  # [S, W, H]
        s = jnp.where(mask[..., None], s, NEG_INF)
        m = jnp.max(s, axis=1)  # [S, H]; -inf for empty segments
        w = jnp.where(mask[..., None], jnp.exp(s - m[:, None, :]), 0.0)
        l = jnp.sum(w, axis=1)  # [S, H]
        if training and p > 0:
            dk = (row_c, nbr_c) if gid is None else (gid[row_c], gid[nbr_c])
            w_agg = w * pair_keep(seed, dk[0][:, None], dk[1], H, p)
        else:
            w_agg = w
        acc = jnp.einsum("swh,swhf->shf", w_agg, x,
                         preferred_element_type=jnp.float32)
        if not with_pos:
            return (m, l, acc), ()
        pos = s >= 0  # LeakyReLU' == 1 (False on padded slots: s == -inf)
        lpos = jnp.sum(jnp.where(pos, w, 0.0), axis=1)  # [S, H]
        accpos = jnp.einsum("swh,swhf->shf", jnp.where(pos, w_agg, 0.0), x,
                            preferred_element_type=jnp.float32)
        return (m, l, lpos, acc, accpos), ()

    outs, _ = scan_chunked(fn, (nbr, row, count), nbr.shape[0], chunk,
                           ())
    if not with_pos:
        m, l, acc = outs
        return m, l, None, acc, None
    return outs


def _gat_forward(adj: BinnedAdj, ar, ac, feat, slope, p, seed, training,
                 with_pos=True, gid=None):
    n = adj.num_rows
    xcat = pack_rows(feat, ac)
    ms, ls, lps, accs, accps, rows = [], [], [], [], [], []
    for width, nbr, edge, row, count in adj.bins():
        m, l, lpos, acc, accpos = _forward_bin(width, nbr, row, count,
                                               ar, ac, feat, xcat, slope, p,
                                               seed, training,
                                               with_pos=with_pos, gid=gid)
        ms.append(m)
        ls.append(l)
        lps.append(lpos)
        accs.append(acc)
        accps.append(accpos)
        rows.append(row)
    l_all = jnp.concatenate(ls)
    acc_all = jnp.concatenate(accs)
    has_pos = with_pos and not any(x is None for x in lps)

    # log-sum-exp merge of row segments (flash-attention-style block combine)
    if adj.cmb is not None:
        # scatter-free: [N, K] combine-table gather (binning.combine_table)
        parts = [l_all, acc_all]
        if has_pos:
            parts += [jnp.concatenate(lps), jnp.concatenate(accps)]
        M, merged = combine_lse(adj.cmb, jnp.concatenate(ms), parts)
        L = merged[0]
        Linv = 1.0 / jnp.maximum(L, 1e-20)
        out = merged[1] * Linv[..., None]
        if not has_pos:
            return out, M, L, None, None
        r = merged[2] * Linv
        out_pos = merged[3] * Linv[..., None]
        return out, M, L, out_pos, r
    m_all = jnp.concatenate(ms)

    row_all = jnp.concatenate(rows)
    M = jax.ops.segment_max(m_all, row_all, num_segments=n)  # [N, H]
    M = jnp.where(jnp.isneginf(M), 0.0, M)
    scale = jnp.where(jnp.isneginf(m_all), 0.0, jnp.exp(m_all - M[row_all]))
    L = _segment_sum(l_all * scale, row_all, n)  # [N, H]
    Linv = 1.0 / jnp.maximum(L, 1e-20)
    out = _segment_sum(acc_all * scale[..., None], row_all, n)
    out = out * Linv[..., None]
    if not has_pos:
        return out, M, L, None, None
    out_pos = _segment_sum(jnp.concatenate(accps) * scale[..., None],
                           row_all, n)
    out_pos = out_pos * Linv[..., None]
    r = _segment_sum(jnp.concatenate(lps) * scale, row_all, n) * Linv
    return out, M, L, out_pos, r


# ---------------------------------------------------------------------------
# Backward pass B: CSC bins -> dX and d attn_col, per-source sums
# ---------------------------------------------------------------------------


def _bwd_csc_bin(width, nbr, row, count, ar, ac, M, L, ws, feat, zcat,
                 g_out, slope, p, seed, training, gid=None):
    """Transposed SpMM + d attn_col, one gather over the CSC bins.  Here
    row = source node, nbr = destination rows; ws rides in the gathered row
    so the (per-dst) weightSum never needs an edge-sized permute:
      dX_j     = sum_i a^_ij grad_out_i
      d ac_j   = sum_i (a^_ij g_ij - a_ij ws_i) d_ij
    (reference analogue: mhspmm_backward_kernel + the grad_attn_col
    atomicAdd, fused_gatconv_kernel.cu:712-763, :957 — scatter-free here.)
    """
    H = ar.shape[-1]
    F = g_out.shape[-1]
    chunk = chunk_rows_for_budget(width, 2 * (H * F + 4 * H))
    HF = H * F

    def fn(nbr_c, row_c, count_c):
        mask = lane_mask(count_c, width)
        z = zcat[nbr_c]  # [S, W, HF+4H] — the ONE edge-sized gather
        gi = z[..., :HF].reshape(z.shape[0], width, H, F)
        sc = unpack_scalars(z, HF)
        ar_i = sc[..., :H]
        M_i = sc[..., H:2 * H]
        Li_i = sc[..., 2 * H:3 * H]  # 1 / max(L, eps), precomputed
        ws_i = sc[..., 3 * H:]
        s_raw = ar_i + ac[row_c][:, None, :]  # [S, W, H]
        a = _recompute_attn(mask, leaky_relu(s_raw, slope), M_i, Li_i)
        if training and p > 0:
            dk = (nbr_c, row_c) if gid is None else (gid[nbr_c], gid[row_c])
            ah = a * pair_keep(seed, dk[0], dk[1][:, None], H, p)
        else:
            ah = a
        dx_p = jnp.einsum("swh,swhf->shf", ah, gi,
                          preferred_element_type=jnp.float32)
        ge = jnp.einsum("shf,swhf->swh", feat[row_c].astype(jnp.float32), gi,
                        preferred_element_type=jnp.float32)
        u = (ah * ge - a * ws_i) * leaky_relu_grad(s_raw, slope)
        return (dx_p, jnp.sum(u, axis=1)), ()

    (dx_p, dac_p), _ = scan_chunked(fn, (nbr, row, count), nbr.shape[0],
                                    chunk, ())
    return dx_p, dac_p


# ---------------------------------------------------------------------------
# custom_vjp wiring
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _gat_fused(slope, p, training, adj_fwd, adj_bwd, ar, ac, feat, seed,
               gid=None):
    # primal-only path (inference / no grads): skip the sign-split work
    out, _, _, _, _ = _gat_forward(adj_fwd, ar, ac, feat, slope, p, seed,
                                   training, with_pos=False, gid=gid)
    return out


def _gat_fused_fwd(slope, p, training, adj_fwd, adj_bwd, ar, ac, feat, seed,
                   gid=None):
    out, M, L, out_pos, r = _gat_forward(adj_fwd, ar, ac, feat, slope, p,
                                         seed, training, gid=gid)
    # Residuals: softmax stats + the sign-split aggregates — per-edge
    # attention is recomputed in the single backward pass.
    return out, (adj_fwd, adj_bwd, ar, ac, feat, M, L, out, out_pos, r, seed,
                 gid)


def _gat_fused_bwd(slope, p, training, res, g_out):
    (adj_fwd, adj_bwd, ar, ac, feat, M, L, out, out_pos, r, seed,
     gid) = res
    g_out = g_out.astype(feat.dtype)
    # Bipartite-general: destination rows (adj_fwd) and source rows (adj_bwd)
    # may be different index spaces (graph shards with halo sources).
    n_src = adj_bwd.num_rows

    # Per-destination softmax backward: closed-form from pass-A residuals
    # (module docstring) — no edge pass.
    g32 = g_out.astype(jnp.float32)
    ws = jnp.einsum("nhf,nhf->nh", g32, out)
    t1 = jnp.einsum("nhf,nhf->nh", g32,
                    slope * out + (1.0 - slope) * out_pos)
    t2 = slope + (1.0 - slope) * r
    d_ar = (t1 - ws * t2).astype(ar.dtype)

    # Pass B over transposed (CSC) bins: dX and d attn_col, per-source sums.
    Linv = 1.0 / jnp.maximum(L, 1e-20)  # once per dst: slots multiply
    zcat = pack_rows(g_out, ar, M, Linv, ws)
    dx_parts, dac_parts, rows_b = [], [], []
    for width, nbr, edge, row, count in adj_bwd.bins():
        dxp, dacp = _bwd_csc_bin(width, nbr, row, count, ar, ac, M, L,
                                 ws, feat, zcat, g_out, slope, p, seed,
                                 training, gid=gid)
        dx_parts.append(dxp)
        dac_parts.append(dacp)
        rows_b.append(row)
    if adj_bwd.cmb is not None:
        # ONE [N, Km]-row merge gather for both outputs (rate-bound rows)
        d_feat, d_ac = combine_sum(adj_bwd.cmb, [jnp.concatenate(dx_parts),
                                                 jnp.concatenate(dac_parts)])
        d_feat = d_feat.astype(feat.dtype)
        d_ac = d_ac.astype(ac.dtype)
    else:
        rows_b = jnp.concatenate(rows_b)
        d_feat = _segment_sum(jnp.concatenate(dx_parts), rows_b,
                              n_src).astype(feat.dtype)
        d_ac = _segment_sum(jnp.concatenate(dac_parts), rows_b,
                            n_src).astype(ac.dtype)
    return (float0_like(adj_fwd), float0_like(adj_bwd), d_ar, d_ac, d_feat,
            float0_like(seed), float0_like(gid))


_gat_fused.defvjp(_gat_fused_fwd, _gat_fused_bwd)


def gat_aggregate(graph: Graph, attn_row, attn_col, feat, *,
                  negative_slope: float = 0.2, attn_drop: float = 0.0,
                  key=None, training: bool = False, gather_dtype=None):
    """Fused GAT neighborhood aggregation.

    out[i, h] = sum_j softmax_j(LeakyReLU(attn_row[i,h] + attn_col[j,h]))
                * feat[j, h, :]        over in-neighbors j of i.

    Reference API analogue: GATConvFuse / GATConvFuse_inference
    (operators/fused_gatconv.py:6-10).

    Args:
      graph: Graph pytree (build_graph).
      attn_row: [N, H] destination attention coefficients.
      attn_col: [N, H] source attention coefficients.
      feat: [N, H, F] node features.
      negative_slope: LeakyReLU slope for edge scores.
      attn_drop: attention dropout probability (training only).
      key: jax PRNG key (required if training and attn_drop > 0).
      training: enables dropout.
      gather_dtype: optional storage dtype (e.g. jnp.bfloat16) for the
        neighbor-feature gathers; accumulation is always f32.
    Returns:
      [N, H, F] aggregated features.
    """
    if training and attn_drop > 0.0:
        if key is None:
            raise ValueError("attn_drop > 0 requires a PRNG key in training")
        seed = jax.random.bits(key, dtype=jnp.uint32)
    else:
        seed = jnp.uint32(0)
    if gather_dtype is not None:
        # shrink the gathered rows (and chunk footprint); accumulation stays
        # f32 (preferred_element_type); the cast's own VJP restores f32
        # parameter gradients outside.
        feat = feat.astype(gather_dtype)
    out = _gat_fused(float(negative_slope), float(attn_drop), bool(training),
                     graph.fwd, graph.bwd, attn_row, attn_col, feat, seed)
    return out.astype(jnp.float32)
