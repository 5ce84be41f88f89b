"""Fused GMM aggregation vs dense oracle: forward + gradients (incl. the
Gaussian-parameter VJP the reference gets wrong, SURVEY.md §2.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgnn.graph.structure import build_graph
from dgnn.ops import reference
from dgnn.ops.gmm import gmm_aggregate
from tests.conftest import random_graph


def _setup(rng, n=50, deg=4, k=3, f=5, d=2, widths=(4, 16)):
    src, dst = random_graph(rng, n, deg)
    g = build_graph(src, dst, n, widths=widths)
    e = g.num_edges
    feat = jnp.asarray(rng.normal(size=(n, k, f)), jnp.float32)
    pseudo = jnp.asarray(rng.normal(size=(e, d)), jnp.float32)
    mu = jnp.asarray(rng.normal(scale=0.1, size=(k, d)), jnp.float32)
    isig = jnp.ones((k, d), jnp.float32)
    eid = reference.dense_edge_ids(np.asarray(g.row_ptr), np.asarray(g.col_ind), n)
    return g, feat, pseudo, mu, isig, eid


def test_forward_matches_dense(rng):
    g, feat, pseudo, mu, isig, eid = _setup(rng)
    out = gmm_aggregate(g, feat, pseudo, mu, isig)
    ref = reference.gmm_dense(eid, feat, pseudo, mu, isig)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_grads_match_dense_autodiff(rng):
    g, feat, pseudo, mu, isig, eid = _setup(rng, n=40, deg=5, k=2, f=3)

    def loss_fused(feat, pseudo, mu, isig):
        return jnp.sum(gmm_aggregate(g, feat, pseudo, mu, isig) ** 2)

    def loss_dense(feat, pseudo, mu, isig):
        return jnp.sum(reference.gmm_dense(eid, feat, pseudo, mu, isig) ** 2)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2, 3))(feat, pseudo, mu, isig)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(feat, pseudo, mu, isig)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_pallas_gmm_matches_dense(rng):
    """GMM fwd+bwd at wide features (K=8, F=128) in a single bin."""
    g, feat, pseudo, mu, isig, eid = _setup(rng, n=48, deg=5, k=8, f=128,
                                            widths=(8,))

    def loss_fused(feat, pseudo, mu, isig):
        return jnp.sum(gmm_aggregate(g, feat, pseudo, mu, isig) ** 2)

    def loss_dense(feat, pseudo, mu, isig):
        return jnp.sum(reference.gmm_dense(eid, feat, pseudo, mu, isig) ** 2)

    out = gmm_aggregate(g, feat, pseudo, mu, isig)
    gf = jax.grad(loss_fused, argnums=(0, 1, 2, 3))(feat, pseudo, mu, isig)
    ref = reference.gmm_dense(eid, feat, pseudo, mu, isig)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(feat, pseudo, mu, isig)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_power_law_split_rows(rng):
    g, feat, pseudo, mu, isig, eid = _setup(rng, n=60, deg=6, widths=(2, 8))

    def loss_fused(feat, pseudo, mu, isig):
        return jnp.sum(jnp.sin(gmm_aggregate(g, feat, pseudo, mu, isig)))

    def loss_dense(feat, pseudo, mu, isig):
        return jnp.sum(jnp.sin(reference.gmm_dense(eid, feat, pseudo, mu, isig)))

    gf = jax.grad(loss_fused, argnums=(0, 1, 2, 3))(feat, pseudo, mu, isig)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(feat, pseudo, mu, isig)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_binned_path_matches_dense(rng):
    """gmm_aggregate_binned (2-pass, projection inside) vs dense autodiff."""
    from dgnn.ops.gmm import bin_pseudo, gmm_aggregate_binned

    g, feat, praw, mu, isig, eid = _setup(rng, n=40, deg=5, k=2, f=3, d=2)
    pbins = bin_pseudo(g, praw)
    dim = 3
    pw = jnp.asarray(np.random.default_rng(7).normal(size=(2, dim)),
                     jnp.float32)
    pb = jnp.asarray(np.random.default_rng(8).normal(size=(dim,)), jnp.float32)
    mu3 = jnp.asarray(np.random.default_rng(9).normal(scale=0.1, size=(2, dim)),
                      jnp.float32)
    isig3 = jnp.ones((2, dim), jnp.float32)

    def loss_fused(feat, pw, pb, mu3, isig3):
        out = gmm_aggregate_binned(g, feat, pbins, mu3, isig3,
                                   proj_weight=pw, proj_bias=pb)
        return jnp.sum(jnp.sin(out))

    def loss_dense(feat, pw, pb, mu3, isig3):
        p = jnp.tanh(praw @ pw + pb)
        return jnp.sum(jnp.sin(reference.gmm_dense(eid, feat, p, mu3, isig3)))

    out = gmm_aggregate_binned(g, feat, pbins, mu3, isig3, proj_weight=pw,
                               proj_bias=pb)
    ref = reference.gmm_dense(eid, feat, jnp.tanh(praw @ pw + pb), mu3, isig3)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    gf = jax.grad(loss_fused, argnums=(0, 1, 2, 3, 4))(feat, pw, pb, mu3, isig3)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2, 3, 4))(feat, pw, pb, mu3, isig3)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_binned_path_identity_proj(rng):
    """Binned path without projection == general flat-pseudo path."""
    from dgnn.ops.gmm import bin_pseudo, gmm_aggregate_binned

    g, feat, praw, mu, isig, eid = _setup(rng, n=50, deg=4, k=3, f=5, d=2,
                                          widths=(2, 8))
    pbins = bin_pseudo(g, praw)
    out_b = gmm_aggregate_binned(g, feat, pbins, mu, isig)
    out_f = gmm_aggregate(g, feat, praw, mu, isig)
    np.testing.assert_allclose(out_b, out_f, rtol=1e-5, atol=1e-5)
