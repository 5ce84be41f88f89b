"""EdgeConv neighbor-max op and k-NN graph construction tests."""

import jax
import jax.numpy as jnp
import numpy as np

from dgnn.graph.knn import knn_graph
from dgnn.ops import reference
from dgnn.ops.edgeconv import (edge_conv_max,
                               edge_conv_max_dense)


def test_forward_matches_dense(rng):
    n, k, f = 30, 5, 7
    nbr = jnp.asarray(rng.integers(0, n, (n, k)), jnp.int32)
    h_src = jnp.asarray(rng.normal(size=(n, f)), jnp.float32)
    h_dst = jnp.asarray(rng.normal(size=(n, f)), jnp.float32)
    out = edge_conv_max(nbr, h_src, h_dst)
    ref = reference.edgeconv_dense(nbr, h_src, h_dst)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_grads_match_dense_autodiff(rng):
    n, k, f = 24, 4, 5
    nbr = jnp.asarray(rng.integers(0, n, (n, k)), jnp.int32)
    h_src = jnp.asarray(rng.normal(size=(n, f)), jnp.float32)
    h_dst = jnp.asarray(rng.normal(size=(n, f)), jnp.float32)

    def loss_fused(hs, hd):
        return jnp.sum(edge_conv_max(nbr, hs, hd) ** 2)

    def loss_dense(hs, hd):
        return jnp.sum(reference.edgeconv_dense(nbr, hs, hd) ** 2)

    gf = jax.grad(loss_fused, argnums=(0, 1))(h_src, h_dst)
    gd = jax.grad(loss_dense, argnums=(0, 1))(h_src, h_dst)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_knn_graph_matches_bruteforce(rng):
    b, p, d, k = 2, 16, 3, 4
    x = rng.normal(size=(b, p, d)).astype(np.float32)
    nbr = np.asarray(knn_graph(jnp.asarray(x), k))
    assert nbr.shape == (b * p, k)
    for bi in range(b):
        d2 = ((x[bi][:, None, :] - x[bi][None, :, :]) ** 2).sum(-1)
        for pi in range(p):
            got = set(nbr[bi * p + pi] - bi * p)
            best = set(np.argsort(d2[pi], kind="stable")[:k])
            # allow tie permutations: compare achieved distances
            got_d = sorted(d2[pi][sorted(got)])
            best_d = sorted(d2[pi][sorted(best)])
            np.testing.assert_allclose(got_d, best_d, atol=1e-5)
            assert all(0 <= g < p for g in got)


def test_knn_includes_self(rng):
    x = jnp.asarray(rng.normal(size=(1, 10, 3)), jnp.float32)
    nbr = np.asarray(knn_graph(x, 3))
    assert all(i in nbr[i] for i in range(10))


def test_dense_masked_matches_gather_path(rng):
    """edge_conv_max_dense (per-cloud dense mask) vs the [N,k] gather path."""
    from dgnn.graph.knn import knn_mask_neg
    from dgnn.ops.edgeconv import edge_conv_max_dense

    b, p, d, k, f = 2, 12, 3, 4, 5
    x = jnp.asarray(rng.normal(size=(b, p, d)), jnp.float32)
    h_src = jnp.asarray(rng.normal(size=(b, p, f)), jnp.float32)
    h_dst = jnp.asarray(rng.normal(size=(b, p, f)), jnp.float32)
    nbr = knn_graph(x, k)  # [B*P, k] global ids
    # exact=True: threshold-membership (bisection) may admit >k neighbors on
    # bf16-rounding ties, which legitimately changes a max — the gather path
    # being compared against is exact top-k
    mask = knn_mask_neg(x, k, exact=True)  # [B, P, P]

    out_g = edge_conv_max(nbr, h_src.reshape(b * p, f),
                          h_dst.reshape(b * p, f))
    out_d = edge_conv_max_dense(mask, h_src, h_dst)
    np.testing.assert_allclose(out_d.reshape(b * p, f), out_g, rtol=1e-6,
                               atol=1e-6)

    def loss_g(hs, hd):
        return jnp.sum(jnp.sin(
            edge_conv_max(nbr, hs.reshape(b * p, f), hd.reshape(b * p, f))))

    def loss_d(hs, hd):
        return jnp.sum(jnp.sin(
            edge_conv_max_dense(mask, hs, hd, mul_dtype=jnp.float32)))

    gg = jax.grad(loss_g, argnums=(0, 1))(h_src, h_dst)
    gd_ = jax.grad(loss_d, argnums=(0, 1))(h_src, h_dst)
    for a_, b_ in zip(gd_, gg):
        np.testing.assert_allclose(a_, b_.reshape(a_.shape), rtol=1e-5,
                                   atol=1e-6)


def test_dense_bwd_bf16_close_to_f32(rng):
    """The production bf16 indicator-multiply backward tracks the exact f32
    one to bf16 rounding (~0.4% relative)."""
    from dgnn.graph.knn import knn_mask_neg

    b, p, f = 2, 64, 96
    x = jnp.asarray(rng.normal(size=(b, p, 3)), jnp.float32)
    h_src = jnp.asarray(rng.normal(size=(b, p, f)), jnp.float32)
    h_dst = jnp.asarray(rng.normal(size=(b, p, f)), jnp.float32)
    mask = knn_mask_neg(x, 8, exact=True)

    def loss(dt):
        def fn(hs):
            return jnp.sum(jnp.sin(
                edge_conv_max_dense(mask, hs, h_dst, mul_dtype=dt)))
        return jax.grad(fn)(h_src)

    g16 = np.asarray(loss(jnp.bfloat16))
    g32 = np.asarray(loss(jnp.float32))
    np.testing.assert_allclose(g16, g32, rtol=5e-3, atol=2e-2)


def test_bisect_mask_superset_of_exact(rng):
    """Bisection membership (bf16 d2, interval slack) always ADMITS the true
    k nearest (may add rounding-tied extras, never drops one)."""
    from dgnn.graph.knn import knn_mask_neg

    b, p, k = 3, 32, 5
    x = jnp.asarray(rng.normal(size=(b, p, 3)), jnp.float32)
    m_bis = np.asarray(knn_mask_neg(x, k)) == 0.0
    m_ex = np.asarray(knn_mask_neg(x, k, exact=True)) == 0.0
    assert (m_bis | ~m_ex).all()  # every exact neighbor is admitted
    assert (m_bis.sum(-1) >= k).all()


def test_dense_masked_first_winner_grad(rng):
    """bwd_mode="argmax": with duplicated source rows (exact ties) the whole
    gradient goes to the FIRST maximal source (deterministic; matches the
    reference kernel's running strictly-greater max,
    fused_edgeconv_kernel.cu:31-38); total mass conserved."""
    b, p, f = 1, 4, 3
    h_src = jnp.zeros((b, p, f), jnp.float32)  # all identical -> all tie
    h_dst = jnp.asarray(rng.normal(size=(b, p, f)), jnp.float32)
    mask = jnp.zeros((b, p, p), jnp.float32)  # fully connected

    def loss(h_src):
        return jnp.sum(edge_conv_max_dense(mask, h_src, h_dst,
                                           bwd_mode="argmax"))

    g = jax.grad(loss)(h_src)
    # every destination row picks source 0: total mass = p per channel
    np.testing.assert_allclose(np.asarray(g[0, 0]), p * np.ones(f))
    np.testing.assert_allclose(np.asarray(g[0, 1:]), 0.0)


def test_dense_tie_sum_grad(rng):
    """Default bwd_mode="tie_sum": on exact ties the gradient is summed over
    every tied source (each of p destinations contributes to all p tied
    sources); tie-free inputs match the argmax mode exactly."""
    b, p, f = 1, 4, 3
    h_src = jnp.zeros((b, p, f), jnp.float32)  # all identical -> all tie
    h_dst = jnp.asarray(rng.normal(size=(b, p, f)), jnp.float32)
    mask = jnp.zeros((b, p, p), jnp.float32)

    g = jax.grad(lambda hs: jnp.sum(
        edge_conv_max_dense(mask, hs, h_dst, mul_dtype=jnp.float32)))(h_src)
    np.testing.assert_allclose(np.asarray(g), p * np.ones((b, p, f)))

    # continuous (tie-free) inputs: identical gradients in both modes
    hs = jnp.asarray(rng.normal(size=(b, 16, f)), jnp.float32)
    hd = jnp.asarray(rng.normal(size=(b, 16, f)), jnp.float32)
    mk = jnp.zeros((b, 16, 16), jnp.float32)

    def loss(mode):
        return jax.grad(lambda a: jnp.sum(edge_conv_max_dense(
            mk, a, hd, mul_dtype=jnp.float32, bwd_mode=mode) ** 2))(hs)

    np.testing.assert_allclose(np.asarray(loss("tie_sum")),
                               np.asarray(loss("argmax")), rtol=1e-6)
