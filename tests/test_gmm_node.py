"""Node-derived-pseudo GMM path (gmm_aggregate_node) vs dense oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from dgnn.graph.structure import build_graph
from dgnn.ops import reference
from dgnn.ops.gmm import gmm_aggregate_node
from tests.conftest import random_graph


def _edge_pseudo_raw(g, s_np, d_np):
    """Flat [E, Ds+Dd] raw pseudo in CSR edge order."""
    row_ptr = np.asarray(g.row_ptr)
    col_ind = np.asarray(g.col_ind)
    rows = np.repeat(np.arange(g.num_nodes), np.diff(row_ptr))
    return np.concatenate([s_np[col_ind], d_np[rows]], axis=1)


def _oracle(g, feat, s_np, d_np, pw, pb, mu, isig, use_tanh=True):
    praw = jnp.asarray(_edge_pseudo_raw(g, s_np, d_np))
    p = praw @ pw + pb
    if use_tanh:
        p = jnp.tanh(p)
    eid = reference.dense_edge_ids(np.asarray(g.row_ptr),
                                   np.asarray(g.col_ind), g.num_nodes)
    return reference.gmm_dense(eid, feat, p, mu, isig)


def _setup(rng, n=40, deg=5, k=2, f=4, d=2):
    src, dst = random_graph(rng, n, deg, power_law=True)
    g = build_graph(src, dst, n, widths=(4, 16))
    feat = jnp.asarray(rng.normal(size=(n, k, f)), jnp.float32)
    s_np = rng.normal(size=(n, 1)).astype(np.float32)
    d_np = rng.normal(size=(n, 1)).astype(np.float32)
    mu = jnp.asarray(rng.normal(size=(k, d)), jnp.float32)
    isig = jnp.asarray(rng.random((k, d)) + 0.5, jnp.float32)
    pw = jnp.asarray(rng.normal(size=(2, d)), jnp.float32)
    pb = jnp.asarray(rng.normal(size=(d,)), jnp.float32)
    return g, feat, s_np, d_np, mu, isig, pw, pb


def test_node_forward_matches_oracle(rng):
    g, feat, s_np, d_np, mu, isig, pw, pb = _setup(rng)
    out = gmm_aggregate_node(g, feat, jnp.asarray(s_np), jnp.asarray(d_np),
                             mu, isig, proj_weight=pw, proj_bias=pb)
    ref = _oracle(g, feat, s_np, d_np, pw, pb, mu, isig)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_node_grads_match_oracle(rng):
    g, feat, s_np, d_np, mu, isig, pw, pb = _setup(rng, n=30, deg=4)
    sj, dj = jnp.asarray(s_np), jnp.asarray(d_np)

    def loss_fused(feat, pw, pb, mu, isig):
        out = gmm_aggregate_node(g, feat, sj, dj, mu, isig, proj_weight=pw,
                                 proj_bias=pb)
        return jnp.sum(jnp.sin(out))

    def loss_ref(feat, pw, pb, mu, isig):
        return jnp.sum(jnp.sin(_oracle(g, feat, s_np, d_np, pw, pb, mu,
                                       isig)))

    gf = jax.grad(loss_fused, argnums=(0, 1, 2, 3, 4))(feat, pw, pb, mu, isig)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2, 3, 4))(feat, pw, pb, mu, isig)
    for name, a, b in zip(("feat", "pw", "pb", "mu", "isig"), gf, gr):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_node_no_tanh(rng):
    g, feat, s_np, d_np, mu, isig, pw, pb = _setup(rng)
    out = gmm_aggregate_node(g, feat, jnp.asarray(s_np), jnp.asarray(d_np),
                             mu, isig, proj_weight=pw, proj_bias=pb,
                             use_tanh=False)
    ref = _oracle(g, feat, s_np, d_np, pw, pb, mu, isig, use_tanh=False)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
