"""Batched k-NN graph construction in JAX.

Replaces the reference's host-side DGL ``KNNGraph`` (rebuilt from features
inside the training loop every layer, train_edgeconv.py:49) with an on-device
pairwise-distance + top-k — a batched matmul, so the dynamic graph never
leaves the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["knn_graph", "knn_mask_neg"]


def knn_graph(x: jax.Array, k: int) -> jax.Array:
    """k nearest neighbors (by squared euclidean distance, self included).

    Args:
      x: [B, P, D] batched point features.
      k: neighbors per point (k <= P).
    Returns:
      [B * P, k] int32 global neighbor ids into the flattened [B * P] point
      set (block-diagonal batching, matching how the reference batches point
      clouds into one graph, train_edgeconv.py:50-52).
    """
    b, p, _ = x.shape
    sq = jnp.sum(x * x, axis=-1)  # [B, P]
    # d2[i, j] = |xi|^2 + |xj|^2 - 2 xi.xj ; constant |xi|^2 dropped (row-wise
    # top-k is invariant to it)
    inner = jnp.einsum("bpd,bqd->bpq", x, x, preferred_element_type=jnp.float32)
    d2 = sq[:, None, :] - 2.0 * inner  # [B, P, P]
    _, idx = jax.lax.top_k(-d2, k)  # [B, P, k]
    offs = (jnp.arange(b, dtype=jnp.int32) * p)[:, None, None]
    return (idx.astype(jnp.int32) + offs).reshape(b * p, k)


def knn_mask_neg(x: jax.Array, k: int, *, neg: float = -1e30,
                 exact: bool = False, bisect_iters: int = 12,
                 refine_iters: int = 0, dtype=jnp.bfloat16) -> jax.Array:
    """Dense k-NN adjacency as an additive max-mask.

    Returns [B, P, P] ``dtype`` (bfloat16 default — the mask is {0, neg}
    and re-read by every F-chunk of the conv) with 0 where j is among i's k
    nearest neighbors (self included) and ``neg`` elsewhere, so
    neighbor-max aggregation is a
    dense, fully-vectorized ``max_j (vals + mask)`` — no per-edge gathers
    (see ops/edgeconv.py).

    The per-row k-th-distance threshold is found by value bisection
    (bandwidth-bound: ~iters passes over [B,P,P]; ``exact=True`` uses
    lax.top_k instead): ``bisect_iters`` cheap passes over
    a bfloat16 copy of d2 narrow the interval, then ``refine_iters``
    full-precision passes tighten it, and the final membership compare is
    f32.  Membership is by threshold, so a row can admit slightly MORE
    than k neighbors (points inside the remaining interval, and exact
    ties).  Measured drift on benchmark-shaped clouds (P=1024, k=40,
    tests/test_cache_and_misc.py::test_knn_bisect_drift_on_modelnet_...):
    mean extra admissions per row: ~22 at round-4's (8 bf16 passes, bf16
    final compare) — its "measure-zero" claim was wrong on real clouds,
    bf16 quantization groups many near-threshold distances; ~6.2 at the
    round-5 defaults (12 bf16 passes — the bf16 tie-group floor); ~4.7
    with refine_iters=2 and ~1.1 with refine_iters=5 (f32 count passes
    cost ~2x bf16 ones, ~0.35 vs 0.18 ms per layer per step at ModelNet
    scale, so the tight settings cost ~25% of inference; a 16-ary
    single-pass search measured 7.7x a plain pass and loses,
    scripts/exp_r5_knn_count.py).
    ``exact=True`` uses lax.top_k.
    """
    sq = jnp.sum(x * x, axis=-1)  # [B, P]
    inner = jnp.einsum("bpd,bqd->bpq", x, x, preferred_element_type=jnp.float32)
    d2 = sq[:, None, :] - 2.0 * inner  # [B, P, P] (row-constant |xi|^2 dropped)
    if exact:
        kth, _ = jax.lax.top_k(-d2, k)  # [B, P, k] negated, descending
        thresh = -kth[..., -1]  # [B, P] k-th smallest distance
        return jnp.where(d2 <= thresh[..., None], 0.0, neg).astype(dtype)
    d2b = d2.astype(jnp.bfloat16)
    lo = jnp.min(d2, axis=-1)  # [B, P] (<= kth distance)
    hi = jnp.max(d2, axis=-1)  # [B, P] (>= kth distance)

    def body_b16(_, loh):
        lo, hi = loh
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(d2b <= mid[..., None].astype(jnp.bfloat16), axis=-1)
        small = cnt < k
        return jnp.where(small, mid, lo), jnp.where(small, hi, mid)

    def body_f32(_, loh):
        lo, hi = loh
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(d2 <= mid[..., None], axis=-1)
        small = cnt < k
        return jnp.where(small, mid, lo), jnp.where(small, hi, mid)

    # bf16 counting passes halve the dominant [B,P,P] re-read; the bf16
    # threshold stays a SUPERSET bound (monotonic rounding).  The f32
    # refinement + f32 final compare remove the bf16 tie-group admissions.
    lo, hi = jax.lax.fori_loop(0, bisect_iters, body_b16, (lo, hi))
    if refine_iters == 0:
        # bf16-throughout: compare membership on the rounded copy too (the
        # rounding is monotonic, so the set stays a superset of the exact
        # k-NN); drift floor ~6 extra/row at ModelNet shape (bf16 ties)
        return jnp.where(d2b <= hi[..., None].astype(jnp.bfloat16), 0.0,
                         neg).astype(dtype)
    # widen by one bf16 ulp before refining in f32: the bf16-counted hi can
    # sit one rounding step below the true k-th distance, and the f32
    # bisection preserves count(d2 <= hi) >= k only if it starts true
    ulp = jnp.abs(hi) * jnp.float32(2.0 ** -7) + jnp.float32(1e-12)
    lo, hi = lo - ulp, hi + ulp
    lo, hi = jax.lax.fori_loop(0, refine_iters, body_f32, (lo, hi))
    thresh = hi  # invariant: count(d2 <= hi) >= k
    return jnp.where(d2 <= thresh[..., None], 0.0, neg).astype(dtype)
