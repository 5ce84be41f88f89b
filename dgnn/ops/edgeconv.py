"""Fused EdgeConv: per-channel neighbor max over fixed-degree k-NN graphs.

A re-design of the reference's `fused_edgeconv` module
(fused_edgeconv_kernel.cu:7-49 forward, :76-86 backward).  The graph is an
implicit fixed-degree edge list: node i's neighbors are ``nbr[i, 0:k]``.

    out[i, f] = max_j (h_dst[i, f] + h_src[nbr[i, j], f])

Backward scatters grad_out to the argmax source — the reference does this
with an atomicAdd racing against a same-launch zero-init (a real cross-block
race, SURVEY.md §2.3); here it is a deterministic XLA scatter-add over saved
argmax positions.

``edge_conv_max_dense`` is the performance path used by the DGCNN model:
point clouds make the k-NN graph block-diagonal with small blocks
(P ~ 1024 points), so neighbor-max is computed DENSELY per cloud under an
additive 0/-inf mask (graph/knn.py:knn_mask_neg).  The dense form does P/k
times the arithmetic of the gather form but needs no gathers, and its
backward is an equally dense argmax-indicator sum instead of a scatter.
Which form is faster on the GPU is not measured yet (ROADMAP).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import chunk_rows_for_budget, float0_like, scan_chunked

__all__ = ["edge_conv_max", "edge_conv_max_dense"]


def _fwd_compute(nbr, h_src, h_dst):
    k = nbr.shape[1]
    F = h_src.shape[-1]
    chunk = chunk_rows_for_budget(k, F)

    def fn(nbr_c, h_dst_c):
        vals = h_dst_c[:, None, :] + h_src[nbr_c]  # [S, k, F]
        kstar = jnp.argmax(vals, axis=1).astype(jnp.int32)  # [S, F]
        out = jnp.max(vals, axis=1)
        return (out, kstar), ()

    (out, kstar), _ = scan_chunked(fn, (nbr, h_dst), nbr.shape[0], chunk, ())
    return out, kstar


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _ec(num_src, nbr, h_src, h_dst):
    out, _ = _fwd_compute(nbr, h_src, h_dst)
    return out


def _ec_fwd(num_src, nbr, h_src, h_dst):
    out, kstar = _fwd_compute(nbr, h_src, h_dst)
    # Residuals: argmax slot per (node, channel) only — the reference likewise
    # saves just max_idx (operators/fused_edgeconv.py:20).
    return out, (nbr, kstar)


def _ec_bwd(num_src, res, g):
    nbr, kstar = res
    n, f = g.shape
    node_star = jnp.take_along_axis(nbr, kstar, axis=1)  # [N, F] argmax source id
    cols = jax.lax.broadcasted_iota(jnp.int32, (n, f), 1)
    d_src = jnp.zeros((num_src, f), g.dtype).at[node_star, cols].add(g)
    # d/d h_dst is the identity (h_dst[i, f] appears in every candidate;
    # reference returns grad_out directly, operators/fused_edgeconv.py:22)
    return (float0_like(nbr), d_src, g)


_ec.defvjp(_ec_fwd, _ec_bwd)


# ---------------------------------------------------------------------------
# Dense-masked per-cloud path (DGCNN performance path)
# ---------------------------------------------------------------------------


# XLA's loop fusion of the [B, P, P, Fc] broadcast+reduce degrades
# super-linearly past ~64 trailing channels (measured 2.5ms at F=64 but 49ms
# at F=256 for the same per-element work) — process F in 64-wide chunks.
_F_CHUNK = 64


def _f_chunks(f):
    return range(0, f, _F_CHUNK)


@jax.jit
def _masked_max(mask_neg, h_src):
    """max_j (h_src[b,j,f] + mask_neg[b,i,j]) — jitted so the [B, P, P, F]
    broadcast fuses into the reduction even when the op is invoked eagerly
    (flax init runs ops op-by-op; unfused this intermediate is 16GB at
    ModelNet scale)."""
    outs = []
    for i in _f_chunks(h_src.shape[-1]):
        s = h_src[..., i:i + _F_CHUNK]
        outs.append(jnp.max(s[:, None, :, :] + mask_neg[:, :, :, None],
                            axis=2))
    return jnp.concatenate(outs, -1) if len(outs) > 1 else outs[0]


@jax.jit
def _masked_max_argmax(mask_neg, h_src):
    """(max, argmax) over j of h_src[b,j,f] + mask_neg[b,i,j], F-chunked.
    argmax is int32 [B, P, F] (first winner, like the reference kernel's
    running strictly-greater max, fused_edgeconv_kernel.cu:31-38).

    Formulated as TWO plain reduces — max, then first-winner index as a
    min-reduce of (j if vals >= m else BIG) over the recomputed (bitwise
    identical) broadcast — instead of XLA's variadic (value, index) argmax
    reduce."""
    p = mask_neg.shape[1]
    jbig = jax.lax.broadcasted_iota(jnp.int32, (1, 1, p, 1), 2)
    ms, ks = [], []
    for i in _f_chunks(h_src.shape[-1]):
        s = h_src[..., i:i + _F_CHUNK]
        vals = s[:, None, :, :] + mask_neg[:, :, :, None]  # fused
        m = jnp.max(vals, axis=2)
        idx = jnp.where(vals >= m[:, :, None, :], jbig, jnp.int32(1 << 20))
        ms.append(m)
        ks.append(jnp.min(idx, axis=2).astype(jnp.int32))
    cat = lambda x: jnp.concatenate(x, -1) if len(x) > 1 else x[0]
    return cat(ms), cat(ks)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _ecd(mul_dtype, bwd_mode, mask_neg, h_src, h_dst):
    return h_dst + _masked_max(mask_neg, h_src)


def _ecd_fwd(mul_dtype, bwd_mode, mask_neg, h_src, h_dst):
    if bwd_mode == "argmax":
        # Compute max AND argmax in the same fused broadcast and save the
        # winner index — backward is ONE integer-compare pass (the
        # reference saves max_idx the same way,
        # operators/fused_edgeconv.py:20).
        m, kstar = _masked_max_argmax(mask_neg, h_src)
        return h_dst + m, (kstar, None, None, mask_neg.shape)
    # "tie_sum": save only the max VALUE — the forward stays a single plain
    # reduce (the index pass costs 2x a max pass, microbench_ec_argmax.py)
    # and backward matches sources by exact value equality instead.
    m = _masked_max(mask_neg, h_src)
    return h_dst + m, (m, mask_neg, h_src, mask_neg.shape)


# Backward-pass chunk: the multiply-form indicator sum tolerates (and
# slightly prefers) wider chunks than the forward broadcast.
_F_CHUNK_BWD = 128


@functools.partial(jax.jit, static_argnames=("mul_dtype",))
def _ecd_dsrc(kstar, g, mul_dtype=jnp.bfloat16):
    """Single-winner max backward, one indicator-multiply pass (F-chunked):
      d_src[b,j,f] = sum_i g[b,i,f] [kstar[b,i,f] == j]
    Deterministic (first maximal j wins, like the reference's running
    strictly-greater max); a dense indicator sum, never a scatter (XLA
    scatters: ~0.2M rows/s).

    Layout/dtype choices (measured, scripts/microbench_edgeconv_variants.py):
    the output index j rides axis 1 so the reduction is over axis 2 like the
    forward (2.4x over reducing axis 1), the 0/1 indicator MULTIPLIES the
    grad instead of selecting it, and the multiply+accumulate runs in bf16
    (2x again; the per-(j,f) sums have ~1 contributor on average, so bf16
    accumulation error is immaterial — pass mul_dtype=float32 for exact)."""
    p = kstar.shape[1]
    jidx = jax.lax.broadcasted_iota(jnp.int32, (1, p, 1, 1), 1)
    outs = []
    for i in range(0, kstar.shape[-1], _F_CHUNK_BWD):
        kc = kstar[..., i:i + _F_CHUNK_BWD]              # [B, P(i), Fc]
        gc = g[..., i:i + _F_CHUNK_BWD].astype(mul_dtype)
        ind = (kc[:, None, :, :] == jidx).astype(mul_dtype)
        outs.append(jnp.sum(ind * gc[:, None, :, :], axis=2))
    out = jnp.concatenate(outs, -1) if len(outs) > 1 else outs[0]
    return out.astype(g.dtype)


@functools.partial(jax.jit, static_argnames=("mul_dtype",))
def _ecd_dsrc_ties(m, mask_neg, h_src, g, mul_dtype=jnp.bfloat16):
    """Value-equality max backward, one indicator-multiply pass (F-chunked):
      d_src[b,j,f] = sum_i g[b,i,f] [h_src[b,j,f] + mask[b,i,j] == m[b,i,f]]
    The recomputed sum is bitwise identical to the forward's (same f32 add,
    different broadcast layout), so the equality hits exactly the maximal
    sources.  On EXACT value ties the gradient is summed over every tied
    source (a valid subgradient, unlike the reference's cross-block race —
    SURVEY.md §2.3); ties require bit-identical h_src rows among a point's
    neighbors, which continuous features never produce.  Worth it because
    the forward then needs no index pass at all (a plain max reduce is the
    cheapest pass over the broadcast, microbench_ec_argmax.py).

    F-chunked at the FORWARD's 64 (not _F_CHUNK_BWD=128): this pass
    broadcasts four operands along different axes and XLA's fusion
    degrades superlinearly past 64 trailing channels (measured 4.5 ms per
    64-chunk but 45 ms for the whole F=256 at 128-wide chunks)."""
    maskT = jnp.swapaxes(mask_neg, 1, 2)  # [B, P_j, P_i]
    outs = []
    for i in range(0, h_src.shape[-1], _F_CHUNK):
        hc = h_src[..., i:i + _F_CHUNK]   # [B, P_j, Fc]
        mc = m[..., i:i + _F_CHUNK]       # [B, P_i, Fc]
        gc = g[..., i:i + _F_CHUNK].astype(mul_dtype)
        vals = hc[:, :, None, :] + maskT[..., None]      # [B, Pj, Pi, Fc]
        ind = (vals == mc[:, None, :, :]).astype(mul_dtype)
        outs.append(jnp.sum(ind * gc[:, None, :, :], axis=2))
    out = jnp.concatenate(outs, -1) if len(outs) > 1 else outs[0]
    return out.astype(g.dtype)


def _ecd_bwd(mul_dtype, bwd_mode, res, g):
    first, mask_neg, h_src, mask_shape = res
    if bwd_mode == "argmax":
        d_src = _ecd_dsrc(first, g, mul_dtype=mul_dtype)
    else:
        d_src = _ecd_dsrc_ties(first, mask_neg, h_src, g,
                               mul_dtype=mul_dtype)
    # d/d h_dst is the identity (reference returns grad_out directly,
    # operators/fused_edgeconv.py:22); the mask is non-differentiable (the
    # zero cotangent is DCE'd — models stop_gradient the mask).
    return (jnp.zeros(mask_shape, jnp.float32), d_src, g)


_ecd.defvjp(_ecd_fwd, _ecd_bwd)


def edge_conv_max_dense(mask_neg, h_src, h_dst, mul_dtype=jnp.bfloat16,
                        bwd_mode: str = "tie_sum"):
    """out[b,i,f] = max over j with mask_neg[b,i,j]==0 of
    (h_dst[b,i,f] + h_src[b,j,f]).

    Fully batched broadcast+reduce — XLA fuses the [B, P, P, F] intermediate
    away (measured ~2.6x faster than a per-cloud lax.map).  The primal
    (inference) path computes only the max.

    Args:
      mask_neg: [B, P, P] f32/bf16 additive adjacency mask (0 = edge, large
        negative = non-edge), from graph/knn.py:knn_mask_neg.
      h_src: [B, P, F]; h_dst: [B, P, F].
      mul_dtype: dtype of the backward indicator multiply (bfloat16 default,
        measured ~2.4x faster; float32 for exact gradients — see _ecd_dsrc).
      bwd_mode: "tie_sum" (default) saves only the max value in forward and
        matches sources by exact value equality in backward — cheapest
        forward, gradient summed over exact-tied sources; "argmax" saves the
        first-winner index in forward (reference semantics,
        fused_edgeconv_kernel.cu:31-38) at the cost of an index pass.
    Returns: [B, P, F].
    """
    return _ecd(mul_dtype, bwd_mode, mask_neg, h_src, h_dst)


def edge_conv_max(nbr, h_src, h_dst):
    """out[i, f] = max over j in nbr[i] of (h_dst[i, f] + h_src[j, f]).

    Reference API analogue: EdgeConvFuse (operators/fused_edgeconv.py:8).

    Args:
      nbr: [N, k] int32 neighbor ids (k-NN list; typically includes i itself).
      h_src: [M, F] source-side features.
      h_dst: [N, F] destination-side features.
    """
    return _ec(h_src.shape[0], nbr, h_src, h_dst)
