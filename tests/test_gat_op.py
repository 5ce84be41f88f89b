"""Fused GAT aggregation vs dense oracle: forward, stats, gradients, dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgnn.graph.structure import build_graph
from dgnn.ops import reference
from dgnn.ops.gat import gat_aggregate, _gat_forward
from tests.conftest import random_graph

jax.config.update("jax_enable_x64", False)


def _setup(rng, n=60, deg=4, h=3, f=5, power_law=False, widths=(4, 16)):
    src, dst = random_graph(rng, n, deg, power_law=power_law)
    g = build_graph(src, dst, n, widths=widths)
    ar = jnp.asarray(rng.normal(size=(n, h)), jnp.float32)
    ac = jnp.asarray(rng.normal(size=(n, h)), jnp.float32)
    feat = jnp.asarray(rng.normal(size=(n, h, f)), jnp.float32)
    adj = reference.dense_adj(np.asarray(g.row_ptr), np.asarray(g.col_ind), n)
    return g, ar, ac, feat, adj


@pytest.mark.parametrize("power_law", [False, True])
def test_forward_matches_dense(rng, power_law):
    g, ar, ac, feat, adj = _setup(rng, power_law=power_law)
    out = gat_aggregate(g, ar, ac, feat, negative_slope=0.2)
    ref, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_forward_stats_match_dense(rng):
    """The softmax stats (M, L) feed the backward's recomputed weights
    exp(s - M) / L, which are exact under any valid bound M; the invariant
    quantity M + log(L) = logsumexp(scores) must match the oracle."""
    g, ar, ac, feat, adj = _setup(rng)
    _, M, L, _, _ = _gat_forward(g.fwd, ar, ac, feat, 0.2, 0.0, jnp.uint32(0),
                                 False)
    _, m_ref, l_ref = reference.gat_dense(adj, ar, ac, feat, 0.2)
    np.testing.assert_allclose(np.asarray(M) + np.log(np.asarray(L)),
                               np.asarray(m_ref) + np.log(np.asarray(l_ref)),
                               rtol=1e-5, atol=1e-5)


def test_grads_match_dense_autodiff(rng):
    """custom_vjp (recompute-based) vs JAX autodiff of the dense oracle."""
    g, ar, ac, feat, adj = _setup(rng, n=50, deg=5, h=2, f=3)

    def loss_fused(ar, ac, feat):
        out = gat_aggregate(g, ar, ac, feat, negative_slope=0.2, training=True)
        return jnp.sum(jnp.sin(out))

    def loss_dense(ar, ac, feat):
        out, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2)
        return jnp.sum(jnp.sin(out))

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(ar, ac, feat)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(ar, ac, feat)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_grads_power_law_split_rows(rng):
    """Gradcheck across bins incl. mega-row splitting (widths force splits)."""
    g, ar, ac, feat, adj = _setup(rng, n=80, deg=6, h=2, f=4,
                                  power_law=True, widths=(2, 8))

    def loss_fused(ar, ac, feat):
        return jnp.sum(gat_aggregate(g, ar, ac, feat) ** 2)

    def loss_dense(ar, ac, feat):
        out, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2)
        return jnp.sum(out ** 2)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(ar, ac, feat)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(ar, ac, feat)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_dropout_forward_matches_dense(rng):
    g, ar, ac, feat, adj = _setup(rng)
    key = jax.random.PRNGKey(7)
    seed = jax.random.bits(key, dtype=jnp.uint32)
    out = gat_aggregate(g, ar, ac, feat, attn_drop=0.5, key=key, training=True)
    ref, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2, attn_drop=0.5,
                                    seed=seed)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_dropout_grads_match_dense(rng):
    g, ar, ac, feat, adj = _setup(rng, n=40, deg=5, h=2, f=3)
    key = jax.random.PRNGKey(3)
    seed = jax.random.bits(key, dtype=jnp.uint32)

    def loss_fused(ar, ac, feat):
        out = gat_aggregate(g, ar, ac, feat, attn_drop=0.3, key=key,
                            training=True)
        return jnp.sum(out ** 2)

    def loss_dense(ar, ac, feat):
        out, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2, attn_drop=0.3,
                                        seed=seed)
        return jnp.sum(out ** 2)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(ar, ac, feat)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(ar, ac, feat)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_zero_in_degree_rows_are_zero(rng):
    # node with no in-edges (no self loops added)
    src = np.array([1, 2, 3])
    dst = np.array([1, 2, 3])  # node 0 isolated
    g = build_graph(src, dst, 4, self_loops=False, widths=(4,))
    ar = jnp.ones((4, 2))
    ac = jnp.ones((4, 2))
    feat = jnp.ones((4, 2, 3))
    out = gat_aggregate(g, ar, ac, feat)
    np.testing.assert_allclose(out[0], 0.0)
    np.testing.assert_allclose(out[1:], 1.0, rtol=1e-6)


def test_jit_and_chunking_consistency(rng):
    """Chunked scan path (tiny budget) must equal unchunked output."""
    import dgnn.ops.common as common
    g, ar, ac, feat, adj = _setup(rng, n=100, deg=8, widths=(4, 16))
    out_big = jax.jit(lambda a, b, c: gat_aggregate(g, a, b, c))(ar, ac, feat)
    orig = common.GATHER_BUDGET_BYTES
    try:
        common.GATHER_BUDGET_BYTES = 4096  # force many chunks
        out_small = jax.jit(lambda a, b, c: gat_aggregate(g, a, b, c))(ar, ac, feat)
    finally:
        common.GATHER_BUDGET_BYTES = orig
    np.testing.assert_allclose(out_big, out_small, rtol=1e-5, atol=1e-6)


def test_inference_primal_matches_vjp_forward(rng):
    """The light primal-only forward (no sign-split accumulators) must equal
    the forward used under differentiation."""
    g, ar, ac, feat, _ = _setup(rng)

    out_inf = gat_aggregate(g, ar, ac, feat)  # primal path
    out_train, _ = jax.vjp(
        lambda a, b, c: gat_aggregate(g, a, b, c), ar, ac, feat)
    np.testing.assert_allclose(out_inf, out_train, rtol=1e-6, atol=1e-6)


def test_chunked_bin_kernel_matches_dense(rng, monkeypatch):
    """Multi-chunk scan over the fused bin kernels (tiny gather budget) and
    ragged kernel grids (S not divisible by the block) must match the
    oracle — forward and gradients."""
    from dgnn.ops import common

    monkeypatch.setattr(common, "GATHER_BUDGET_BYTES", 64 * 1024)
    g, ar, ac, feat, adj = _setup(rng, n=90, deg=5, h=2, f=4,
                                  power_law=True, widths=(4, 8))

    def loss_fused(ar, ac, feat):
        return jnp.sum(gat_aggregate(g, ar, ac, feat) ** 2)

    def loss_dense(ar, ac, feat):
        out, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2)
        return jnp.sum(out ** 2)

    out = gat_aggregate(g, ar, ac, feat, negative_slope=0.2)
    ref, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(ar, ac, feat)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(ar, ac, feat)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("widths", [(256,), (2, 4)])
def test_power_law_wide_and_split_bins_match_dense(rng, widths):
    """Hub-heavy graph through one wide bin (every row in one segment) and
    through narrow bins that split every hub into many segments merged by
    the combine tables: forward and gradients against the oracle."""
    g, ar, ac, feat, adj = _setup(rng, n=120, deg=8, h=2, f=4,
                                  power_law=True, widths=widths)
    out = gat_aggregate(g, ar, ac, feat)
    ref, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    def loss_fused(ar, ac, feat):
        return jnp.sum(jnp.sin(gat_aggregate(g, ar, ac, feat,
                                             training=True)))

    def loss_dense(ar, ac, feat):
        return jnp.sum(jnp.sin(reference.gat_dense(adj, ar, ac, feat,
                                                   0.2)[0]))

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(ar, ac, feat)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(ar, ac, feat)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p", [0.3, 0.7])
def test_dropout_split_bins_match_dense(rng, p):
    """Attention dropout on split hub rows: the pair hash re-derives the
    same mask in every segment (CSR forward) and in the transposed pass."""
    g, ar, ac, feat, adj = _setup(rng, n=90, deg=6, h=2, f=3,
                                  power_law=True, widths=(2, 8))
    key = jax.random.PRNGKey(11)
    seed = jax.random.bits(key, dtype=jnp.uint32)

    def loss_fused(ar, ac, feat):
        return jnp.sum(gat_aggregate(g, ar, ac, feat, attn_drop=p, key=key,
                                     training=True) ** 2)

    def loss_dense(ar, ac, feat):
        out, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2,
                                        attn_drop=p, seed=seed)
        return jnp.sum(out ** 2)

    out = gat_aggregate(g, ar, ac, feat, attn_drop=p, key=key,
                        training=True)
    ref, _, _ = reference.gat_dense(adj, ar, ac, feat, 0.2, attn_drop=p,
                                    seed=seed)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(ar, ac, feat)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(ar, ac, feat)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("widths", [(256,), (2, 8)])
def test_bf16_gather_close_to_dense(rng, widths):
    """bf16 gathered rows with f32 accumulation, in wide and in split bins:
    against the oracle on the same bf16-rounded features, the forward and
    every gradient stay within bf16 rounding, because the attention logits
    and softmax statistics ride the gathered rows as exact f32."""
    g, ar, ac, feat, adj = _setup(rng, n=100, deg=6, h=2, f=8,
                                  power_law=True, widths=widths)
    feat_r = feat.astype(jnp.bfloat16).astype(jnp.float32)
    out = gat_aggregate(g, ar, ac, feat, gather_dtype=jnp.bfloat16)
    ref, _, _ = reference.gat_dense(adj, ar, ac, feat_r, 0.2)
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    ct = jnp.asarray(rng.normal(size=feat.shape), jnp.float32)
    _, vjp = jax.vjp(lambda a, b, c: gat_aggregate(
        g, a, b, c, gather_dtype=jnp.bfloat16), ar, ac, feat)
    _, vjp_r = jax.vjp(lambda a, b, c: reference.gat_dense(
        adj, a, b, c.astype(jnp.bfloat16).astype(jnp.float32), 0.2)[0],
        ar, ac, feat)
    for a, b in zip(vjp(ct), vjp_r(ct)):
        scale = float(jnp.max(jnp.abs(b)))
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-2 * scale
