"""Shared machinery for the fused graph ops.

- slot masking for padded degree-binned tables,
- memory-bounded chunked execution (gathers of [segments, width, H, F]
  neighbor-feature tiles are processed in fixed-size chunks under `lax.scan`
  so peak HBM stays bounded regardless of graph size — this is how the build
  achieves the reference's recompute-based memory win, SURVEY.md §2.2 inv. 1),
- a counter-based stateless PRNG for edge dropout: the reference materializes
  a curand uniform mask over [nnz, heads] (fused_gatconv_kernel.cu:333-341)
  and re-reads it in backward through `permute`; we instead *re-derive* the
  mask from (seed, dst id, src id, head) with an integer hash (pair_keep),
  so forward (CSR bins), backward (CSC bins) and the dense hub-block path
  agree bit-for-bit with zero per-edge storage.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pack_rows",
    "unpack_scalars",
    "combine_sum",
    "combine_lse",
    "lane_mask",
    "edge_keep",
    "pair_keep",
    "float0_like",
    "scan_chunked",
    "chunk_rows_for_budget",
    "NEG_INF",
]

NEG_INF = float("-inf")

# Default per-chunk gather budget (bytes) for neighbor-feature tiles.
# Larger budgets mean fewer scan iterations over wide bins (per-iteration
# overhead) at the cost of peak HBM; override via DGNN_GATHER_BUDGET_MB.
import os as _os

GATHER_BUDGET_BYTES = int(_os.environ.get("DGNN_GATHER_BUDGET_MB",
                                          "256")) * 1024 * 1024


def gather_budget_bytes() -> int:
    """Current chunk budget: env override wins over the import-time default
    (lets a benchmark config trade a little scan overhead for peak HBM —
    the gathered [W, chunk, C] blocks are the dominant temporaries at
    Reddit scale)."""
    mb = _os.environ.get("DGNN_GATHER_BUDGET_MB")
    return int(mb) * 1024 * 1024 if mb else GATHER_BUDGET_BYTES


def pack_rows(feat, *scalars):
    """One gatherable row table ``[feat | scalars]``.

    ``feat`` keeps its dtype (a 16-bit gather dtype halves the gathered
    bytes); the scalar columns (attention logits, softmax statistics,
    pseudo projections) stay exact float32: in a 16-bit table each float32
    rides as two 16-bit halves (bitcast), recovered by ``unpack_scalars``.
    Rounding them to bf16 instead put errors of up to a third of the
    largest attention-logit gradient into the backward pass."""
    feat = feat.reshape(feat.shape[0], -1)
    sc = jnp.concatenate([s.reshape(s.shape[0], -1).astype(jnp.float32)
                          for s in scalars], axis=1)
    if jnp.dtype(feat.dtype).itemsize == 4:
        return jnp.concatenate([feat, sc.astype(feat.dtype)], axis=1)
    halves = jax.lax.bitcast_convert_type(sc, feat.dtype)  # [N, k, 2]
    return jnp.concatenate([feat, halves.reshape(sc.shape[0], -1)], axis=1)


def unpack_scalars(z, num_feat: int):
    """float32 scalar columns of gathered ``pack_rows`` rows ``z``."""
    tail = z[..., num_feat:]
    if jnp.dtype(z.dtype).itemsize == 4:
        return tail.astype(jnp.float32)
    return jax.lax.bitcast_convert_type(
        tail.reshape(tail.shape[:-1] + (-1, 2)), jnp.float32)


def lane_mask(count: jax.Array, width: int) -> jax.Array:
    """[S] counts -> [S, width] bool validity mask."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)
    return lane < count[:, None]


def _mix32(x: jax.Array) -> jax.Array:
    """murmur3 finalizer (public-domain bit mixer) on uint32."""
    x = x ^ (x >> 16)
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def edge_keep(seed: jax.Array, edge: jax.Array, num_heads: int, p: float) -> jax.Array:
    """Deterministic per-(edge, head) inverted-dropout keep mask.

    Returns float mask of shape edge.shape + (num_heads,) with values in
    {0, 1/(1-p)}.  Keep rule `u > p` matches the reference's
    `edge_mask[...] > attn_drop` (fused_gatconv_kernel.cu:95-104).
    """
    e = edge.astype(jnp.uint32)[..., None]
    h = jax.lax.broadcasted_iota(jnp.uint32, e.shape[:-1] + (num_heads,), e.ndim - 1)
    z = e * np.uint32(num_heads) + h
    z = _mix32(z ^ (seed.astype(jnp.uint32) * np.uint32(0x9E3779B9)))
    u = (z >> 8).astype(jnp.float32) * np.float32(1.0 / (1 << 24))
    return jnp.where(u > p, np.float32(1.0 / (1.0 - p)), 0.0)


def pair_keep(seed: jax.Array, dst: jax.Array, src: jax.Array,
              num_heads: int, p: float) -> jax.Array:
    """Deterministic per-(dst, src, head) inverted-dropout keep mask.

    ``dst``/``src`` are broadcastable integer node-id arrays; the result has
    shape broadcast(dst, src) + (num_heads,) with values in {0, 1/(1-p)}.

    Keyed on the edge's ENDPOINTS rather than its edge id, so every layout
    (CSR bins, transposed CSC bins, dense hub blocks — which never
    materialize per-pair edge ids) re-derives bit-identical masks.  The
    reference materializes a curand [nnz, h] mask and re-indexes it through
    `permute` instead (fused_gatconv_kernel.cu:333-341, :738).  The only
    semantic difference: parallel duplicate edges share one mask draw
    (benchmark graphs are simple graphs, so none exist after dedup).
    """
    d = dst.astype(jnp.uint32)
    s = src.astype(jnp.uint32)
    base = _mix32(d * np.uint32(0x9E3779B9)
                  ^ _mix32(s ^ seed.astype(jnp.uint32) * np.uint32(0x85EBCA6B)))
    z = base[..., None] * np.uint32(num_heads) + jax.lax.broadcasted_iota(
        jnp.uint32, base.shape + (num_heads,), base.ndim)
    z = _mix32(z)
    u = (z >> 8).astype(jnp.float32) * np.float32(1.0 / (1 << 24))
    return jnp.where(u > p, np.float32(1.0 / (1.0 - p)), 0.0)


def float0_like(tree):
    """Cotangents for non-differentiable pytree leaves.

    The custom_vjp contract only permits ``float0`` cotangents for integer /
    bool primal leaves; a float-dtype leaf (e.g. float32 pseudo tables that
    the op treats as constants) must get a real zero cotangent of the same
    dtype or JAX rejects the bwd rule under shard_map's vma checking
    (round-3 MULTICHIP failure).  The zeros are traced (jnp), so they carry
    the surrounding shard_map's varying-mesh-axes and are DCE'd by XLA
    whenever the caller never requests that gradient.
    """
    def zero(x):
        if jnp.issubdtype(jnp.result_type(x), jnp.inexact):
            return jnp.zeros_like(x)
        return np.zeros(np.shape(x), dtype=jax.dtypes.float0)

    return jax.tree.map(zero, tree)


def chunk_rows_for_budget(width: int, elems_per_slot: int, itemsize: int = 4,
                          budget: int | None = None) -> int:
    """Segments per chunk so a [chunk, width, elems] gather fits the budget."""
    if budget is None:
        budget = gather_budget_bytes()
    rows = budget // max(1, width * elems_per_slot * itemsize)
    # floor of 1: very wide bins (unsplit hub rows, width up to 128K) must
    # shrink the chunk below 8 segments or a "chunk" alone exceeds the budget
    rows = max(1, int(rows))
    return int(min(rows, 1 << 30))


def scan_chunked(fn, args, num_rows: int, chunk: int, accum_init):
    """Run ``fn(*row_slices) -> (stacked, accum)`` over leading-axis chunks.

    ``stacked`` outputs (leading dim == chunk) are concatenated back to the
    original row count; ``accum`` outputs are tree-summed across chunks.

    Chunks are sliced from the ORIGINAL arrays inside the loop
    (dynamic_slice), never pad+reshape-copied — at Reddit scale the stacked
    copies of the bin tables cost gigabytes of extra live HBM per op
    instance.  The remainder rows run as one static tail call.
    """
    if num_rows <= chunk:
        return fn(*args)

    n_full = num_rows // chunk
    tail = num_rows - n_full * chunk

    def body(acc, i):
        sliced = tuple(
            jax.lax.dynamic_slice_in_dim(x, i * chunk, chunk, axis=0)
            for x in args)
        stacked, upd = fn(*sliced)
        acc = jax.tree.map(jnp.add, acc, upd)
        return acc, stacked

    accum, stacked = jax.lax.scan(body, accum_init,
                                  jnp.arange(n_full, dtype=jnp.int32))
    stacked = jax.tree.map(
        lambda x: x.reshape((n_full * chunk,) + x.shape[2:]), stacked)
    if tail:
        t_stacked, t_upd = fn(*(x[n_full * chunk:] for x in args))
        accum = jax.tree.map(jnp.add, accum, t_upd)
        stacked = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                               stacked, t_stacked)
    return stacked, accum


def _merge_sum(tbl, zcat, widths):
    """Masked K-way sum over gathered concat rows, split back per part.

    K separate 2-D gathers + elementwise adds, not one [R, K, C] gather +
    reduce: K is static and tiny (capped combine width), the rows gathered
    are the same either way, and the 3-D form materializes [R, K, small]-
    minor tensors whose layouts degenerate at H=1."""
    k = tbl.shape[1]
    s = None
    for j in range(k):
        tj = tbl[:, j]
        g = zcat[jnp.maximum(tj, 0)]  # [R, C]
        g = jnp.where((tj >= 0)[:, None], g, 0)
        s = g if s is None else s + g
    outs, off = [], 0
    for w in widths:
        outs.append(s[..., off:off + w])
        off += w
    return outs


def combine_sum(cmb, vals):
    """Scatter-free segment merge: out[r] = sum over row r's partials.

    ``cmb`` is a graph.CombineTable: positions into the concatenated
    per-segment partial rows — an [N, Km] gather + masked reduce, never a
    segment_sum.  The few overflow rows (more partials than the capped Km)
    merge through the tiny [V, K] side table and are patched in by row id.

    ``vals``: one [S, ...] array or a list of them, merged via ONE gather
    of the concatenated rows instead of one gather per part.  Returns
    matching structure.
    """
    single = not isinstance(vals, (list, tuple))
    parts = [vals] if single else list(vals)
    shapes = [p.shape[1:] for p in parts]
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    widths = [p.shape[1] for p in flat]
    zcat = flat[0] if len(flat) == 1 else jnp.concatenate(flat, axis=1)
    outs = _merge_sum(cmb.main, zcat, widths)
    if cmb.ov_rows.shape[0]:
        outs_ov = _merge_sum(cmb.ov, zcat, widths)
        outs = [o.at[cmb.ov_rows].set(ov) for o, ov in zip(outs, outs_ov)]
    outs = [o.reshape((o.shape[0],) + sh) for o, sh in zip(outs, shapes)]
    return outs[0] if single else outs


def _merge_lse(tbl, zcat, H, widths):
    """LSE-rescaled masked K-way sum over gathered concat rows
    ([m | parts...]); every part width is a multiple of H (per-head
    scalars or [H, F] blocks) so the exp(m - M) scale broadcasts by
    reshape along the concat axis.

    Structured as K separate 2-D gathers + elementwise combines rather
    than one [R, K, C] gather + axis-1 reductions — same gathered rows,
    but no [R, K, small]-minor 3-D tensors,
    whose layouts degenerate at H=1 (see _merge_sum)."""
    k = tbl.shape[1]
    R = tbl.shape[0]
    gs, ms = [], []
    for j in range(k):
        tj = tbl[:, j]
        g = zcat[jnp.maximum(tj, 0)]  # [R, H + sum]
        gs.append((tj, g))
        ms.append(jnp.where((tj >= 0)[:, None], g[:, :H], NEG_INF))
    M = ms[0]
    for mj in ms[1:]:
        M = jnp.maximum(M, mj)
    M0 = jnp.where(jnp.isneginf(M), 0.0, M)
    scales = [jnp.where(jnp.isneginf(mj), 0.0, jnp.exp(mj - M0))
              for mj in ms]
    outs, off = [], H
    for w in widths:
        s = None
        for (tj, g), scale in zip(gs, scales):
            blk = g[:, off:off + w]
            if w == H:
                term = blk * scale
            else:
                term = (blk.reshape(R, H, w // H)
                        * scale[:, :, None]).reshape(R, w)
            s = term if s is None else s + term
        off += w
        outs.append(s)
    return M0, outs


def combine_lse(cmb, m: jax.Array, parts):
    """Log-sum-exp segment merge over combine-table positions.

    m: [S, H] per-segment maxima (NEG_INF for empty).  ``parts``: list of
    per-segment arrays ([S, H] or [S, H, F]) to be rescaled by
    exp(m - M_row) and summed.  All parts (and m) ride ONE gathered
    concatenated row per table entry (one gather, not len(parts)+1).
    Returns
    (M [N, H], merged parts...)."""
    H = m.shape[-1]
    shapes = [p.shape[1:] for p in parts]
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    widths = [p.shape[1] for p in flat]
    zcat = jnp.concatenate([m] + flat, axis=1)
    M0, outs = _merge_lse(cmb.main, zcat, H, widths)
    if cmb.ov_rows.shape[0]:
        M_ov, outs_ov = _merge_lse(cmb.ov, zcat, H, widths)
        M0 = M0.at[cmb.ov_rows].set(M_ov)
        outs = [o.at[cmb.ov_rows].set(ov) for o, ov in zip(outs, outs_ov)]
    outs = [o.reshape((o.shape[0],) + sh) for o, sh in zip(outs, shapes)]
    return M0, outs


def leaky_relu(x: jax.Array, slope: float) -> jax.Array:
    return jnp.where(x >= 0, x, x * slope)


def leaky_relu_grad(x: jax.Array, slope: float) -> jax.Array:
    return jnp.where(x >= 0, jnp.float32(1.0), jnp.float32(slope))
