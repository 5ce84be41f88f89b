"""Fused MoNet/GMMConv aggregation: Gaussian edge weights fused with SpMM.

A re-design of the reference's `fused_gmmconv` module
(fused_gmmconv_kernel.cu:24-55 `fuseGmm`, :57-87 `gaussian_bp`;
operators/fused_gmmconv.py:12-27).  Per edge e=(u -> v) with pseudo-coords
``pseudo[e]`` and K Gaussian kernels:

    w[e, k] = exp(-0.5 * sum_d ((pseudo[e,d] - mu[k,d]) * inv_sigma[k,d])^2)
    out[v, k, :] = sum_{e into v} w[e, k] * feat[u, k, :]

Two implementations:

- ``gmm_aggregate_binned`` — the performance path (used by the MoNet model).
  Raw pseudo-coordinates are *pre-binned* into the per-bin ``[S, W, D]`` slot
  tables once per graph, in BOTH layouts, so a training step performs exactly
  TWO edge-sized gathers and nothing else per-edge (see ops/gat.py):
    fwd  (CSR bins): gather feat rows; Gaussian weights computed per-slot
                     from the streamed pseudo tables
    bwd  (CSC bins): gather grad_out rows; the same pass yields dX (per-src
                     sums), the SDDMM gw = <grad_out[dst], feat[src]> with
                     *resident* source features, and all parameter gradients
                     (mu, inv_sigma, pseudo-projection) as in-pass global
                     sums.  The reference needs three kernels plus an edge
                     permute for this (operators/fused_gmmconv.py:20-27).
  The per-layer pseudo projection Linear(2, dim) + tanh lives *inside* the
  op so its gradient is a global sum too (the reference's MoNet applies it
  per edge outside the kernel, train_gmmconv.py:38,48).

- ``gmm_aggregate`` — the general API-parity path taking flat ``pseudo
  [E, D]`` in CSR edge order with full differentiability (reference API
  analogue: GmmConvFuse).  Its backward materializes per-edge weight grads
  and is not rate-optimal; large-scale training should use the binned path.

Backward math is the exact closed-form VJP of the Gaussian (the reference's
hand-written `gaussian_bp` has known bugs — garbage accumulation base and a
wrong running sum across dims, SURVEY.md §2.4 — which this derivation does
not replicate).
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp

from ..graph.structure import BinnedAdj, Graph
from .common import (chunk_rows_for_budget, combine_sum, float0_like,
                     lane_mask, pack_rows, scan_chunked, unpack_scalars)

__all__ = ["gmm_aggregate", "gmm_aggregate_binned", "gmm_aggregate_node",
           "NodePseudo", "gaussian_weights", "bin_edge_data"]


def gaussian_weights(pseudo, mu, inv_sigma):
    """[..., D], [K, D], [K, D] -> [..., K] Gaussian kernel weights."""
    t = (pseudo[..., None, :] - mu) * inv_sigma  # [..., K, D]
    return jnp.exp(-0.5 * jnp.sum(t * t, axis=-1))


def bin_edge_data(adj: BinnedAdj, data):
    """Scatter flat per-edge data [E, ...] into the bin slot tables.

    One edge-sized gather, done ONCE per graph at setup — per-step passes
    then stream the [S, W, ...] tables instead of re-gathering.
    """
    return tuple(data[e] for e in adj.edge)


def _segment_sum(x, ids, n):
    return jax.ops.segment_sum(x, ids, num_segments=n)


def _project(praw, pw, pbias, use_tanh):
    p = praw.astype(jnp.float32) @ pw + pbias
    return jnp.tanh(p) if use_tanh else p


# ---------------------------------------------------------------------------
# Binned fast path: 2 edge-sized gathers per training step
# ---------------------------------------------------------------------------


def _proj_unrolled(praw_c, pw, pbias, use_tanh):
    """Projected pseudo as a list of D arrays shaped [S, W] — K and D are
    tiny (2-3) so arrays shaped [..., K, D] put them in the lane-minor
    position, which XLA pads to 128 lanes (a 64-256x VPU/layout waste at
    scale).  Unrolling keeps W as the minor dim everywhere."""
    din = praw_c.shape[-1]
    D = pw.shape[1]
    praw_d = [praw_c[..., r].astype(jnp.float32) for r in range(din)]
    out = []
    for d in range(D):
        p = pbias[d] + sum(praw_d[r] * pw[r, d] for r in range(din))
        out.append(jnp.tanh(p) if use_tanh else p)
    return out


def _gauss_k(p_d, mu, isig, k):
    """[S, W] Gaussian weight of kernel k from unrolled pseudo dims."""
    q = sum(((p_d[d] - mu[k, d]) * isig[k, d]) ** 2 for d in range(len(p_d)))
    return jnp.exp(-0.5 * q)


def _gmm2_forward(adj: BinnedAdj, pbins, feat, pw, pbias, mu, isig, use_tanh):
    n = adj.num_rows
    K, F = feat.shape[-2], feat.shape[-1]
    accs, rows = [], []
    for (width, nbr, edge, row, count), praw in zip(adj.bins(), pbins):
        chunk = chunk_rows_for_budget(width, K * F + praw.shape[-1])

        def fn(nbr_c, count_c, praw_c):
            mask = lane_mask(count_c, width)
            p_d = _proj_unrolled(praw_c, pw, pbias, use_tanh)
            x = feat[nbr_c]  # [S, W, K, F] — the ONE edge-sized gather
            acc_k = []
            for k in range(K):
                w = jnp.where(mask, _gauss_k(p_d, mu, isig, k), 0.0)  # [S, W]
                acc_k.append(jnp.einsum(
                    "sw,swf->sf", w, x[:, :, k, :],
                    preferred_element_type=jnp.float32))
            return (jnp.stack(acc_k, axis=1),), ()

        (acc,), _ = scan_chunked(fn, (nbr, count, praw), nbr.shape[0], chunk,
                                 ())
        accs.append(acc)
        rows.append(row)
    if adj.cmb is not None:
        return combine_sum(adj.cmb, jnp.concatenate(accs))
    return _segment_sum(jnp.concatenate(accs), jnp.concatenate(rows), n)


def _gmm2_backward(adj_bwd: BinnedAdj, pbins_bwd, feat, pw, pbias, mu, isig,
                   use_tanh, g_out):
    """Single CSC pass: dX (per-src sums), SDDMM with resident src features,
    and every parameter gradient as an in-pass global sum."""
    n_src = adj_bwd.num_rows
    K, F = feat.shape[-2], feat.shape[-1]
    din = pw.shape[0]
    D = pw.shape[1]
    zeros = (jnp.zeros((K, D), jnp.float32), jnp.zeros((K, D), jnp.float32),
             jnp.zeros((din, D), jnp.float32), jnp.zeros((D,), jnp.float32))
    d_mu, d_isig, d_pw, d_pbias = zeros
    dxs, rows = [], []
    for (width, nbr, edge, row, count), praw in zip(adj_bwd.bins(), pbins_bwd):
        chunk = chunk_rows_for_budget(width, 2 * (K * F + K * D))

        def fn(nbr_c, row_c, count_c, praw_c):
            # unrolled over (K, D) — see _proj_unrolled: keeps W lane-minor
            mask = lane_mask(count_c, width)
            K_, D_ = mu.shape
            din = praw_c.shape[-1]
            p_d = _proj_unrolled(praw_c, pw, pbias, use_tanh)
            g = g_out[nbr_c]  # [S, W, K, F] — the ONE edge-sized gather
            x_res = feat[row_c].astype(jnp.float32)  # [S, K, F] resident
            dx_k = []
            dmu = jnp.zeros((K_, D_), jnp.float32)
            disg = jnp.zeros((K_, D_), jnp.float32)
            dp_d = [jnp.zeros_like(p_d[0]) for _ in range(D_)]
            for k in range(K_):
                w = jnp.where(mask, _gauss_k(p_d, mu, isig, k), 0.0)  # [S, W]
                g_k = g[:, :, k, :]  # [S, W, F]
                dx_k.append(jnp.einsum("sw,swf->sf", w, g_k,
                                       preferred_element_type=jnp.float32))
                gw = jnp.einsum("sf,swf->sw", x_res[:, k, :], g_k,
                                preferred_element_type=jnp.float32)
                c = gw * w  # [S, W] (w==0 masks padded slots)
                for d in range(D_):
                    t_d = (p_d[d] - mu[k, d]) * isig[k, d]  # [S, W]
                    # d w/d mu = w t isig ; d w/d isig = -w t (p - mu)
                    dmu = dmu.at[k, d].add(jnp.sum(c * t_d) * isig[k, d])
                    disg = disg.at[k, d].add(
                        -jnp.sum(c * t_d * (p_d[d] - mu[k, d])))
                    dp_d[d] = dp_d[d] - c * t_d * isig[k, d]
            dpw = jnp.zeros((din, D_), jnp.float32)
            dpb = jnp.zeros((D_,), jnp.float32)
            for d in range(D_):
                dpre = dp_d[d] * (1.0 - p_d[d] * p_d[d]) if use_tanh \
                    else dp_d[d]
                dpb = dpb.at[d].add(jnp.sum(dpre))
                for r in range(din):
                    dpw = dpw.at[r, d].add(
                        jnp.sum(praw_c[..., r].astype(jnp.float32) * dpre))
            return (jnp.stack(dx_k, axis=1),), (dmu, disg, dpw, dpb)

        (dx_p,), upd = scan_chunked(fn, (nbr, row, count, praw), nbr.shape[0],
                                    chunk, zeros)
        d_mu = d_mu + upd[0]
        d_isig = d_isig + upd[1]
        d_pw = d_pw + upd[2]
        d_pbias = d_pbias + upd[3]
        dxs.append(dx_p)
        rows.append(row)
    if adj_bwd.cmb is not None:
        d_feat = combine_sum(adj_bwd.cmb, jnp.concatenate(dxs))
    else:
        d_feat = _segment_sum(jnp.concatenate(dxs), jnp.concatenate(rows),
                              n_src)
    return d_feat, d_pw, d_pbias, d_mu, d_isig


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gmm2(use_tanh, adj_fwd, adj_bwd, pf, pb, feat, pw, pbias, mu, isig):
    return _gmm2_forward(adj_fwd, pf, feat, pw, pbias, mu, isig, use_tanh)


def _gmm2_fwd(use_tanh, adj_fwd, adj_bwd, pf, pb, feat, pw, pbias, mu, isig):
    out = _gmm2_forward(adj_fwd, pf, feat, pw, pbias, mu, isig, use_tanh)
    return out, (adj_fwd, adj_bwd, pf, pb, feat, pw, pbias, mu, isig)


def _gmm2_bwd(use_tanh, res, g_out):
    adj_fwd, adj_bwd, pf, pb, feat, pw, pbias, mu, isig = res
    g_out = g_out.astype(jnp.float32)
    d_feat, d_pw, d_pbias, d_mu, d_isig = _gmm2_backward(
        adj_bwd, pb, feat, pw, pbias, mu, isig, use_tanh, g_out)
    return (float0_like(adj_fwd), float0_like(adj_bwd), float0_like(pf),
            float0_like(pb), d_feat.astype(feat.dtype), d_pw.astype(pw.dtype),
            d_pbias.astype(pbias.dtype), d_mu.astype(mu.dtype),
            d_isig.astype(isig.dtype))


_gmm2.defvjp(_gmm2_fwd, _gmm2_bwd)


def gmm_aggregate_binned(graph: Graph, feat, pseudo_bins, mu, inv_sigma, *,
                         proj_weight=None, proj_bias=None,
                         use_tanh: bool = True):
    """Fused MoNet aggregation over pre-binned pseudo-coordinates.

    Args:
      graph: Graph pytree.
      feat: [N, K, F] node features.
      pseudo_bins: (fwd_tables, bwd_tables) from ``bin_pseudo(graph, raw)`` —
        raw pseudo-coords in both binned layouts (treated as constants; to
        learn pseudo itself use `gmm_aggregate`).
      mu, inv_sigma: [K, D] Gaussian parameters.
      proj_weight, proj_bias: optional pseudo projection (Linear(Din, D)
        [+ tanh]) applied per-slot inside the op; identity if None.
      use_tanh: apply tanh after the projection (reference MoNet does,
        train_gmmconv.py:38,48).
    Returns:
      [N, K, F] aggregated features.
    """
    pf, pb = pseudo_bins
    din = pf[0].shape[-1]
    if proj_weight is None:
        proj_weight = jnp.eye(din, mu.shape[1], dtype=jnp.float32)
        proj_bias = jnp.zeros((mu.shape[1],), jnp.float32)
        use_tanh = False
    if proj_bias is None:
        proj_bias = jnp.zeros((mu.shape[1],), jnp.float32)
    return _gmm2(bool(use_tanh), graph.fwd, graph.bwd, pf, pb, feat,
                 proj_weight, proj_bias, mu, inv_sigma)


def bin_pseudo(graph: Graph, pseudo):
    """Pre-bin raw [E, Din] pseudo-coords into both layouts (once per graph)."""
    return (bin_edge_data(graph.fwd, pseudo), bin_edge_data(graph.bwd, pseudo))


# ---------------------------------------------------------------------------
# General flat-pseudo path (API parity; differentiable pseudo)
# ---------------------------------------------------------------------------


def _spmm_bins(adj: BinnedAdj, w_flat, feat):
    """out[row, k, f] = sum_slots w_flat[edge, k] * feat[nbr, k, f]."""
    n = adj.num_rows
    K = w_flat.shape[-1]
    F = feat.shape[-1]
    accs, rows = [], []
    for width, nbr, edge, row, count in adj.bins():
        chunk = chunk_rows_for_budget(width, K * F)

        def fn(nbr_c, edge_c, count_c):
            mask = lane_mask(count_c, width)  # [S, W]
            w = jnp.where(mask[..., None], w_flat[edge_c], 0.0)  # [S, W, K]
            x = feat[nbr_c]  # [S, W, K, F]
            acc = jnp.einsum("swk,swkf->skf", w, x,
                             preferred_element_type=jnp.float32)
            return (acc,), ()

        (acc,), _ = scan_chunked(fn, (nbr, edge, count), nbr.shape[0], chunk, ())
        accs.append(acc)
        rows.append(row)
    if adj.cmb is not None:
        return combine_sum(adj.cmb, jnp.concatenate(accs))
    return _segment_sum(jnp.concatenate(accs), jnp.concatenate(rows), n)


def _sddmm_bins(adj: BinnedAdj, grad_out, feat, num_edges):
    """grad_w[e, k] = <grad_out[row(e), k, :], feat[col(e), k, :]> in flat
    CSR edge order: per-slot results emit in concatenated slot order and
    re-order through the build-time inverse slot table ``adj.epos`` — ONE
    edge-sized gather, never a segment_sum scatter (reference analogue:
    mhsddmm, mhsddmm_kernel.cu)."""
    assert adj.epos is not None, \
        "flat-pseudo GMM needs a graph built with edge_tables=True"
    K = grad_out.shape[1]
    F = grad_out.shape[-1]
    parts = []
    for width, nbr, edge, row, count in adj.bins():
        chunk = chunk_rows_for_budget(width, 2 * K * F)

        def fn(nbr_c, row_c, count_c):
            mask = lane_mask(count_c, width)
            g = jnp.einsum("skf,swkf->swk", grad_out[row_c], feat[nbr_c],
                           preferred_element_type=jnp.float32)
            return (jnp.where(mask[..., None], g, 0.0),), ()

        (g,), _ = scan_chunked(fn, (nbr, row, count), nbr.shape[0], chunk,
                               ())
        parts.append(g.reshape(-1, K))
    return jnp.concatenate(parts)[adj.epos]


@jax.custom_vjp
def _gmm_fused(adj_fwd, adj_bwd, feat, pseudo, mu, inv_sigma):
    w_flat = gaussian_weights(pseudo, mu, inv_sigma)
    return _spmm_bins(adj_fwd, w_flat, feat)


def _gmm_fused_fwd(adj_fwd, adj_bwd, feat, pseudo, mu, inv_sigma):
    out = _gmm_fused(adj_fwd, adj_bwd, feat, pseudo, mu, inv_sigma)
    return out, (adj_fwd, adj_bwd, feat, pseudo, mu, inv_sigma)


def _gmm_fused_bwd(res, g_out):
    adj_fwd, adj_bwd, feat, pseudo, mu, inv_sigma = res
    w_flat, gauss_vjp = jax.vjp(gaussian_weights, pseudo, mu, inv_sigma)
    # dX: forward SpMM on the transposed graph (bwd bins carry CSR edge ids,
    # so the same flat weights index correctly).
    d_feat = _spmm_bins(adj_bwd, w_flat, g_out).astype(feat.dtype)
    # dW: per-edge SDDMM, then exact VJP through the Gaussian closed form.
    gw = _sddmm_bins(adj_fwd, g_out, feat, adj_fwd.num_edges)
    d_pseudo, d_mu, d_inv_sigma = gauss_vjp(gw)
    return (float0_like(adj_fwd), float0_like(adj_bwd), d_feat,
            d_pseudo.astype(pseudo.dtype), d_mu.astype(mu.dtype),
            d_inv_sigma.astype(inv_sigma.dtype))


_gmm_fused.defvjp(_gmm_fused_fwd, _gmm_fused_bwd)


def gmm_aggregate(graph: Graph, feat, pseudo, mu, inv_sigma):
    """Fused MoNet aggregation (general flat-pseudo API).

    Args:
      graph: Graph pytree.
      feat: [N, K, F] node features (K = number of Gaussian kernels).
      pseudo: [E, D] per-edge pseudo-coordinates in CSR edge order.
      mu: [K, D] kernel means.
      inv_sigma: [K, D] kernel inverse widths.
    Returns:
      [N, K, F] aggregated features (caller sums over K, as the reference
      layer does: layers/gmmconv_layer.py:58).
    """
    return _gmm_fused(graph.fwd, graph.bwd, feat, pseudo, mu, inv_sigma)


# ---------------------------------------------------------------------------
# Node-derived pseudo path: pseudo[e=(u->v)] = [src_scalars[u], dst_scalars[v]]
# ---------------------------------------------------------------------------
#
# The reference's citation-graph protocol uses pseudo = [1/sqrt(deg_u),
# 1/sqrt(deg_v)] (train_gmmconv.py:120-122) — a function of the edge's
# ENDPOINTS.  Deriving it inside the pass from per-node scalars removes the
# [slots, W, D] pseudo tables entirely (2 x ~1.3 GB at Reddit scale, the
# round-1 OOM), lets the projection Linear(Din, D)+tanh collapse to
# per-node alpha/beta arrays (pre_d = alpha_d[u] + beta_d[v]).  All
# parameter gradients are in-pass global sums.


class NodePseudo(typing.NamedTuple):
    """Per-node pseudo-coordinate sources for ``gmm_aggregate_node``:
    pseudo[e=(u -> v)] = concat(src[u], dst[v]).  For the reference's
    citation protocol both are rsqrt(in/out degree) [N, 1]
    (train_gmmconv.py:120-122)."""

    src: jax.Array  # [N, Ds]
    dst: jax.Array  # [N, Dd]


def _node_fwd(adj: BinnedAdj, alpha, beta, feat, mu, isig, use_tanh):
    """CSR pass: out[v] = sum_u gauss(tanh(alpha[u] + beta[v])) * x[u]."""
    n = adj.num_rows
    K, F = feat.shape[-2], feat.shape[-1]
    D = mu.shape[1]
    KF = K * F
    xcat = pack_rows(feat, alpha)
    accs, rows = [], []
    for width, nbr, edge, row, count in adj.bins():
        chunk = chunk_rows_for_budget(width, KF + D)

        def fn(nbr_c, row_c, count_c):
            mask = lane_mask(count_c, width)
            g = xcat[nbr_c]  # [S, W, KF+D] — the ONE edge-sized gather
            x = g[..., :KF].reshape(g.shape[0], width, K, F)
            a_u = unpack_scalars(g, KF)  # [S, W, D]
            b_v = beta[row_c]  # [S, D] resident
            p_d = []
            for d in range(D):
                pre = a_u[..., d] + b_v[:, d][:, None]
                p_d.append(jnp.tanh(pre) if use_tanh else pre)
            acc_k = []
            for k in range(K):
                w = jnp.where(mask, _gauss_k(p_d, mu, isig, k), 0.0)
                acc_k.append(jnp.einsum("sw,swf->sf", w, x[:, :, k, :],
                                        preferred_element_type=jnp.float32))
            return (jnp.stack(acc_k, axis=1),), ()

        (acc,), _ = scan_chunked(fn, (nbr, row, count), nbr.shape[0], chunk,
                                 ())
        accs.append(acc)
        rows.append(row)
    if adj.cmb is not None:
        return combine_sum(adj.cmb, jnp.concatenate(accs))
    return _segment_sum(jnp.concatenate(accs), jnp.concatenate(rows), n)


def _node_bwd(adj_bwd: BinnedAdj, alpha, beta, sfeat, dfeat, feat, mu, isig,
              use_tanh, g_out):
    """Single CSC pass: dX per-source sums; dmu/disg/d(alpha proj)/d(beta
    proj) as in-pass global sums.  Rows = sources (alpha, feat resident);
    gathered rows carry [g_out | beta | dfeat]."""
    n_src = adj_bwd.num_rows
    K, F = feat.shape[-2], feat.shape[-1]
    D = mu.shape[1]
    Dd = dfeat.shape[-1]
    KF = K * F
    # gathered rows in feat's dtype: under gather_dtype=bfloat16 the
    # backward's rows halve like the forward's (scalars stay f32, pack_rows)
    zcat = pack_rows(g_out.astype(feat.dtype), beta, dfeat)
    zeros = (jnp.zeros((K, D), jnp.float32), jnp.zeros((K, D), jnp.float32),
             jnp.zeros((D,), jnp.float32),
             jnp.zeros((sfeat.shape[-1], D), jnp.float32),
             jnp.zeros((Dd, D), jnp.float32))
    d_mu, d_isig, d_pb, d_pws, d_pwd = zeros
    dxs, rows = [], []
    for (width, nbr, edge, row, count) in adj_bwd.bins():
        chunk = chunk_rows_for_budget(width, 2 * (KF + D + Dd))

        def fn(nbr_c, row_c, count_c):
            mask = lane_mask(count_c, width)
            z = zcat[nbr_c]  # [S, W, KF+D+Dd] — the ONE edge-sized gather
            g = z[..., :KF].reshape(z.shape[0], width, K, F)
            sc = unpack_scalars(z, KF)
            b_v = sc[..., :D]   # [S, W, D]
            df_v = sc[..., D:]  # [S, W, Dd]
            a_u = alpha[row_c]                             # [S, D] resident
            x_res = feat[row_c].astype(jnp.float32)        # [S, K, F]
            p_d = []
            for d in range(D):
                pre = b_v[..., d] + a_u[:, d][:, None]
                p_d.append(jnp.tanh(pre) if use_tanh else pre)
            dx_k = []
            dmu = jnp.zeros((K, D), jnp.float32)
            disg = jnp.zeros((K, D), jnp.float32)
            dp = [jnp.zeros_like(p_d[0]) for _ in range(D)]
            for k in range(K):
                w = jnp.where(mask, _gauss_k(p_d, mu, isig, k), 0.0)
                g_k = g[:, :, k, :]
                dx_k.append(jnp.einsum("sw,swf->sf", w, g_k,
                                       preferred_element_type=jnp.float32))
                gw = jnp.einsum("sf,swf->sw", x_res[:, k, :], g_k,
                                preferred_element_type=jnp.float32)
                c = gw * w
                for d in range(D):
                    t_d = (p_d[d] - mu[k, d]) * isig[k, d]
                    dmu = dmu.at[k, d].add(jnp.sum(c * t_d) * isig[k, d])
                    disg = disg.at[k, d].add(
                        -jnp.sum(c * t_d * (p_d[d] - mu[k, d])))
                    dp[d] = dp[d] - c * t_d * isig[k, d]
            dpb = jnp.zeros((D,), jnp.float32)
            dpws = jnp.zeros((sfeat.shape[-1], D), jnp.float32)
            dpwd = jnp.zeros((Dd, D), jnp.float32)
            sf_res = sfeat[row_c].astype(jnp.float32)  # [S, Ds]
            for d in range(D):
                dpre = dp[d] * (1.0 - p_d[d] * p_d[d]) if use_tanh else dp[d]
                dpb = dpb.at[d].add(jnp.sum(dpre))
                row_sums = jnp.sum(dpre, axis=1)  # [S]
                for i in range(sfeat.shape[-1]):
                    dpws = dpws.at[i, d].add(jnp.sum(row_sums * sf_res[:, i]))
                for i in range(Dd):
                    dpwd = dpwd.at[i, d].add(jnp.sum(dpre * df_v[..., i]))
            return (jnp.stack(dx_k, axis=1),), (dmu, disg, dpb, dpws, dpwd)

        (dx_p,), upd = scan_chunked(fn, (nbr, row, count), nbr.shape[0],
                                    chunk, zeros)
        d_mu = d_mu + upd[0]
        d_isig = d_isig + upd[1]
        d_pb = d_pb + upd[2]
        d_pws = d_pws + upd[3]
        d_pwd = d_pwd + upd[4]
        dxs.append(dx_p)
        rows.append(row)
    if adj_bwd.cmb is not None:
        d_feat = combine_sum(adj_bwd.cmb, jnp.concatenate(dxs))
    else:
        d_feat = _segment_sum(jnp.concatenate(dxs), jnp.concatenate(rows),
                              n_src)
    return d_feat, d_mu, d_isig, d_pb, d_pws, d_pwd


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gmm_node(use_tanh, adj_fwd, adj_bwd, sfeat, dfeat, feat, pw_s, pw_d,
              pbias, mu, isig):
    alpha = sfeat.astype(jnp.float32) @ pw_s
    beta = dfeat.astype(jnp.float32) @ pw_d + pbias
    return _node_fwd(adj_fwd, alpha, beta, feat, mu, isig, use_tanh)


def _gmm_node_fwd(use_tanh, adj_fwd, adj_bwd, sfeat, dfeat, feat, pw_s, pw_d,
                  pbias, mu, isig):
    out = _gmm_node(use_tanh, adj_fwd, adj_bwd, sfeat, dfeat, feat, pw_s,
                    pw_d, pbias, mu, isig)
    return out, (adj_fwd, adj_bwd, sfeat, dfeat, feat, pw_s, pw_d, pbias, mu,
                 isig)


def _gmm_node_bwd(use_tanh, res, g_out):
    adj_fwd, adj_bwd, sfeat, dfeat, feat, pw_s, pw_d, pbias, mu, isig = res
    alpha = sfeat.astype(jnp.float32) @ pw_s
    beta = dfeat.astype(jnp.float32) @ pw_d + pbias
    g_out = g_out.astype(jnp.float32)
    d_feat, d_mu, d_isig, d_pb, d_pws, d_pwd = _node_bwd(
        adj_bwd, alpha, beta, sfeat, dfeat, feat, mu, isig, use_tanh, g_out)
    return (float0_like(adj_fwd), float0_like(adj_bwd), float0_like(sfeat),
            float0_like(dfeat), d_feat.astype(feat.dtype),
            d_pws.astype(pw_s.dtype), d_pwd.astype(pw_d.dtype),
            d_pb.astype(pbias.dtype), d_mu.astype(mu.dtype),
            d_isig.astype(isig.dtype))


_gmm_node.defvjp(_gmm_node_fwd, _gmm_node_bwd)


def gmm_aggregate_node(graph: Graph, feat, src_scalars, dst_scalars, mu,
                       inv_sigma, *, proj_weight, proj_bias,
                       use_tanh: bool = True, gather_dtype=None):
    """Fused MoNet aggregation with NODE-derived pseudo-coordinates.

    The pseudo-coordinate of edge (u -> v) is
    ``concat(src_scalars[u], dst_scalars[v])`` projected by
    Linear(Ds+Dd, D) [+ tanh] — the reference's citation protocol
    (pseudo = [1/sqrt(deg_u), 1/sqrt(deg_v)], train_gmmconv.py:120-122)
    with the projection folded into per-node alpha/beta arrays.  No
    per-edge pseudo is ever materialized (2 x ~1.3 GB saved at Reddit
    scale).

    Args:
      feat: [N, K, F]; src_scalars: [N, Ds]; dst_scalars: [N, Dd]
        (non-differentiable, e.g. rsqrt degrees).
      mu, inv_sigma: [K, D]; proj_weight: [Ds+Dd, D]; proj_bias: [D].
      gather_dtype: optional storage dtype (e.g. jnp.bfloat16) for the
        gathered neighbor rows in BOTH passes; accumulation stays f32 and
        the cast's own VJP restores f32 parameter gradients outside.
    Returns [N, K, F].
    """
    ds = src_scalars.shape[-1]
    pw_s = proj_weight[:ds]
    pw_d = proj_weight[ds:]
    if gather_dtype is not None:
        feat = feat.astype(gather_dtype)
    out = _gmm_node(bool(use_tanh), graph.fwd, graph.bwd, src_scalars,
                    dst_scalars, feat, pw_s, pw_d, proj_bias, mu, inv_sigma)
    return out.astype(jnp.float32)
