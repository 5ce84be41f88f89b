"""Naive (edge-materializing) baselines agree with the fused ops."""

import jax
import jax.numpy as jnp
import numpy as np

from dgnn.graph.structure import build_graph
from dgnn.ops.gat import gat_aggregate
from dgnn.ops.gmm import gmm_aggregate
from dgnn.ops.naive import gat_naive, gmm_naive
from tests.conftest import random_graph


def test_gat_naive_matches_fused(rng):
    n, h, f = 60, 2, 5
    src, dst = random_graph(rng, n, 5)
    g = build_graph(src, dst, n, widths=(4, 16))
    ar = jnp.asarray(rng.normal(size=(n, h)), jnp.float32)
    ac = jnp.asarray(rng.normal(size=(n, h)), jnp.float32)
    feat = jnp.asarray(rng.normal(size=(n, h, f)), jnp.float32)
    np.testing.assert_allclose(gat_naive(g, ar, ac, feat),
                               gat_aggregate(g, ar, ac, feat),
                               rtol=1e-5, atol=1e-5)
    # dropout parity: same seed hash -> same mask in both impls
    key = jax.random.PRNGKey(5)
    np.testing.assert_allclose(
        gat_naive(g, ar, ac, feat, attn_drop=0.4, key=key, training=True),
        gat_aggregate(g, ar, ac, feat, attn_drop=0.4, key=key, training=True),
        rtol=1e-5, atol=1e-5)


def test_gmm_naive_matches_fused(rng):
    n, k, f, d = 40, 3, 4, 2
    src, dst = random_graph(rng, n, 4)
    g = build_graph(src, dst, n, widths=(4, 16))
    feat = jnp.asarray(rng.normal(size=(n, k, f)), jnp.float32)
    pseudo = jnp.asarray(rng.normal(size=(g.num_edges, d)), jnp.float32)
    mu = jnp.asarray(rng.normal(scale=0.1, size=(k, d)), jnp.float32)
    isig = jnp.ones((k, d), jnp.float32)
    np.testing.assert_allclose(gmm_naive(g, feat, pseudo, mu, isig),
                               gmm_aggregate(g, feat, pseudo, mu, isig),
                               rtol=1e-5, atol=1e-5)
