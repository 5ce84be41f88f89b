"""Layer/model smoke + training-dynamics tests: shapes, loss decreases."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dgnn.graph.structure import build_graph
from dgnn.models import DGCNN, GAT, GATConv, GMMConv, MoNet
from tests.conftest import random_graph


@pytest.fixture
def small_graph(rng):
    n = 40
    src, dst = random_graph(rng, n, 4)
    return build_graph(src, dst, n, widths=(4, 16)), n


def test_gatconv_shapes(rng, small_graph):
    g, n = small_graph
    feat = jnp.asarray(rng.normal(size=(n, 10)), jnp.float32)
    layer = GATConv(in_feats=10, out_feats=8, num_heads=3, residual=True)
    params = layer.init(jax.random.PRNGKey(0))
    out = layer.apply(params, g, feat)
    assert out.shape == (n, 3, 8)


def test_gat_net_trains(rng, small_graph):
    g, n = small_graph
    feat = jnp.asarray(rng.normal(size=(n, 12)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 3, n), jnp.int32)
    model = GAT(num_layers=1, n_hidden=8, n_classes=3, heads=[2, 1],
                feat_drop=0.2, attn_drop=0.2)
    params = model.init(jax.random.PRNGKey(0), 12)
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, key):
        def loss_fn(p):
            logits = model.apply(p, g, feat, training=True, key=key)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.PRNGKey(1)
    losses = []
    for i in range(30):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses


def test_monet_trains(rng, small_graph):
    g, n = small_graph
    feat = jnp.asarray(rng.normal(size=(n, 10)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 4, n), jnp.int32)
    deg = jnp.maximum(g.in_degrees().astype(jnp.float32), 1.0)
    # pseudo coords = [1/sqrt(deg_u), 1/sqrt(deg_v)] per CSR edge
    # (reference train_gmmconv.py:120-122)
    row = jnp.repeat(jnp.arange(n), jnp.diff(g.row_ptr), total_repeat_length=g.num_edges)
    pseudo = jnp.stack([jax.lax.rsqrt(deg)[g.col_ind],
                        jax.lax.rsqrt(deg)[row]], axis=1)
    model = MoNet(n_hidden=8, out_feats=4, n_layers=1, dim=2, n_kernels=3,
                  dropout=0.0)
    params = model.init(jax.random.PRNGKey(0), 10, pseudo)
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits = model.apply(p, g, feat, pseudo)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses


def test_dgcnn_forward_and_step(rng):
    x = jnp.asarray(rng.normal(size=(2, 32, 3)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 5, 2), jnp.int32)
    model = DGCNN(k=8, feature_dims=(8, 8), emb_dims=(16, 16),
                  output_classes=5, dropout=0.5)
    params, state = model.init(jax.random.PRNGKey(0))
    logits, _ = model.apply(params, state, x, training=True,
                            key=jax.random.PRNGKey(1))
    assert logits.shape == (2, 5)

    def loss_fn(params):
        out, _ = model.apply(params, state, x, training=True,
                             key=jax.random.PRNGKey(2))
        return optax.softmax_cross_entropy_with_integer_labels(out, labels).mean()

    grads = jax.grad(loss_fn)(params)
    flat = jax.tree.leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(x))) for x in flat)
    assert any(np.any(np.asarray(x) != 0) for x in flat)


def test_gat_param_shapes():
    """Parameter tree of the reference config: xavier-initialised
    projections and attention vectors, bias only past the input layer."""
    model = GAT(num_layers=1, n_hidden=8, n_classes=3, heads=(4, 1))
    p = model.init(jax.random.PRNGKey(0), 12)
    shapes = jax.tree.map(lambda a: a.shape, p)
    assert shapes == {
        "gat_0": {"W": (12, 32), "attn_l": (1, 4, 8), "attn_r": (1, 4, 8)},
        "gat_out": {"W": (32, 3), "attn_l": (1, 1, 3), "attn_r": (1, 1, 3),
                    "bias": (1, 1, 3)}}
    # xavier-normal (relu gain): std = sqrt(2 * 2 / (fan_in + fan_out))
    np.testing.assert_allclose(np.std(np.asarray(p["gat_0"]["W"])),
                               np.sqrt(4.0 / (12 + 32)), rtol=0.25)
    monet = MoNet(n_hidden=8, out_feats=3, n_layers=1, dim=2, n_kernels=3)
    from dgnn.ops.gmm import NodePseudo
    ps = NodePseudo(src=jnp.ones((5, 1)), dst=jnp.ones((5, 1)))
    mp = monet.init(jax.random.PRNGKey(1), 10, ps)
    assert jax.tree.map(lambda a: a.shape, mp)["gmm_0"] == {
        "fc": (10, 24), "mu": (3, 2), "inv_sigma": (3, 2),
        "pseudo_w": (2, 2), "pseudo_b": (2,), "bias": (8,)}
    np.testing.assert_array_equal(mp["gmm_0"]["inv_sigma"], 1.0)


def test_batchnorm_state_updates_in_training_only(rng):
    x = jnp.asarray(rng.normal(size=(4, 16, 3)), jnp.float32)
    model = DGCNN(k=4, feature_dims=(8, 8), emb_dims=(16, 16),
                  output_classes=5, dropout=0.0)
    params, state = model.init(jax.random.PRNGKey(0))
    assert set(state) == {"bn_1"}
    np.testing.assert_array_equal(state["bn_1"]["mean"], 0.0)
    np.testing.assert_array_equal(state["bn_1"]["var"], 1.0)
    _, s_train = model.apply(params, state, x, training=True,
                             key=jax.random.PRNGKey(1))
    _, s_eval = model.apply(params, state, x)
    assert float(jnp.abs(s_train["bn_1"]["mean"]).max()) > 0.0
    jax.tree.map(np.testing.assert_array_equal, s_eval, state)
    # the layer itself: batch statistics normalise in training and enter
    # the running statistics as an exponential moving average (0.99)
    from dgnn.models.layers import batch_norm_apply, batch_norm_init
    h = jnp.asarray(rng.normal(2.0, 3.0, size=(64, 5)), jnp.float32)
    bp, bs = batch_norm_init(5)
    y, bs2 = batch_norm_apply(bp, bs, h, training=True)
    np.testing.assert_allclose(jnp.mean(y, 0), 0.0, atol=1e-5)
    np.testing.assert_allclose(jnp.std(y, 0), 1.0, rtol=1e-3)
    np.testing.assert_allclose(bs2["mean"], 0.01 * jnp.mean(h, 0), rtol=1e-5)
    np.testing.assert_allclose(bs2["var"], 0.99 + 0.01 * jnp.var(h, 0),
                               rtol=1e-5)
    y_eval, bs3 = batch_norm_apply(bp, bs2, h, training=False)
    np.testing.assert_allclose(
        y_eval, (h - bs2["mean"]) / jnp.sqrt(bs2["var"] + 1e-5), rtol=1e-5)
    assert bs3 is bs2


@pytest.mark.parametrize("name", ["gat", "monet", "dgcnn"])
def test_dropout_off_at_inference(rng, small_graph, name):
    """With training=False every dropout is the identity: outputs do not
    depend on the key; with training=True they do."""
    g, n = small_graph
    feat = jnp.asarray(rng.normal(size=(n, 6)), jnp.float32)
    if name == "gat":
        model = GAT(num_layers=1, n_hidden=4, n_classes=3, heads=(2, 1),
                    feat_drop=0.5, attn_drop=0.5)
        params = model.init(jax.random.PRNGKey(0), 6)
        run = lambda tr, k: model.apply(params, g, feat, training=tr, key=k)
    elif name == "monet":
        from dgnn.ops.gmm import NodePseudo
        ps = NodePseudo(src=jnp.ones((n, 1)), dst=jnp.ones((n, 1)))
        model = MoNet(n_hidden=4, out_feats=3, n_layers=2, dim=2,
                      n_kernels=2, dropout=0.5)
        params = model.init(jax.random.PRNGKey(0), 6, ps)
        run = lambda tr, k: model.apply(params, g, feat, ps, training=tr,
                                        key=k)
    else:
        x = jnp.asarray(rng.normal(size=(2, 16, 3)), jnp.float32)
        model = DGCNN(k=4, feature_dims=(8, 8), emb_dims=(16, 16),
                      output_classes=5, dropout=0.5)
        params, state = model.init(jax.random.PRNGKey(0))
        run = lambda tr, k: model.apply(params, state, x, training=tr,
                                        key=k)[0]
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    np.testing.assert_array_equal(run(False, k1), run(False, k2))
    np.testing.assert_array_equal(run(False, k1), run(False, None))
    assert not np.allclose(run(True, k1), run(True, k2))
