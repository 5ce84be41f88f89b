"""Multi-shard SPMD tests on the virtual 8-device CPU mesh: sharded forward
and gradients must match the single-device fused op exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from dgnn.graph.structure import build_graph
from dgnn.models import GAT
from dgnn.parallel import (ShardedGAT, local_view, partition_graph)
from tests.conftest import random_graph


def _mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("graph",))


@pytest.mark.parametrize("num_shards", [2, 4])
def test_sharded_forward_matches_single(rng, num_shards):
    n, h, f = 48, 2, 4
    src, dst = random_graph(rng, n, 5)
    mesh = _mesh(num_shards)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16))
    g = build_graph(src, dst, n, widths=(4, 16))
    c = shards.nodes_per_shard
    n_pad = shards.padded_nodes

    feat = rng.normal(size=(n, 12)).astype(np.float32)
    feat_pad = np.zeros((n_pad, 12), np.float32)
    feat_pad[:n] = feat

    model = ShardedGAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1))
    ref_model = GAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1))

    params = ref_model.init(jax.random.PRNGKey(0), 12)

    def per_shard(params, shards, x):
        return model.apply(params, local_view(shards), x)

    fwd = shard_map(per_shard, mesh=mesh,
                    in_specs=(P(), P("graph"), P("graph")),
                    out_specs=P("graph"))
    out = jax.jit(fwd)(params, shards, jnp.asarray(feat_pad))
    ref = ref_model.apply(params, g, jnp.asarray(feat))
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_sharded_grads_match_single(rng):
    n, h, f, num_shards = 40, 2, 4, 4
    src, dst = random_graph(rng, n, 4)
    mesh = _mesh(num_shards)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16))
    g = build_graph(src, dst, n, widths=(4, 16))
    n_pad = shards.padded_nodes

    feat = rng.normal(size=(n, 10)).astype(np.float32)
    feat_pad = np.zeros((n_pad, 10), np.float32)
    feat_pad[:n] = feat
    labels = rng.integers(0, 3, n).astype(np.int32)
    labels_pad = np.zeros(n_pad, np.int32)
    labels_pad[:n] = labels
    mask_pad = np.zeros(n_pad, np.float32)
    mask_pad[:n] = 1.0

    model = ShardedGAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1))
    ref_model = GAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1))
    params = ref_model.init(jax.random.PRNGKey(1), 10)

    def per_shard_logits(params, shards, x):
        return model.apply(params, local_view(shards), x)

    fwd = shard_map(per_shard_logits, mesh=mesh,
                    in_specs=(P(), P("graph"), P("graph")),
                    out_specs=P("graph"))

    def loss_sharded(params):
        logits = fwd(params, shards, jnp.asarray(feat_pad))
        ls = -jax.nn.log_softmax(logits)[jnp.arange(n_pad), jnp.asarray(labels_pad)]
        return jnp.sum(ls * jnp.asarray(mask_pad)) / n

    def loss_single(params):
        logits = ref_model.apply(params, g, jnp.asarray(feat))
        ls = -jax.nn.log_softmax(logits)[jnp.arange(n), jnp.asarray(labels)]
        return jnp.mean(ls)

    gs = jax.jit(jax.grad(loss_sharded))(params)
    gr = jax.grad(loss_single)(params)
    flat_s = jax.tree_util.tree_leaves_with_path(gs)
    flat_r = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(gr)}
    for k, v in flat_s:
        np.testing.assert_allclose(np.asarray(v),
                                   np.asarray(flat_r[jax.tree_util.keystr(k)]),
                                   rtol=5e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("widths", [None, (4, 16)])
def test_sharded_attn_dropout_matches_single(rng, widths):
    """pair_keep keys on GLOBAL node ids in the sharded path (ext_gids), so
    the attention-dropout mask — local bins and halo bins alike — is
    bit-identical to single-chip for the same rng."""
    n, h, f, num_shards, p_drop = 48, 2, 4, 4, 0.4
    src, dst = random_graph(rng, n, 6, power_law=True)
    mesh = _mesh(num_shards)
    shards = partition_graph(src, dst, n, num_shards, widths=widths)
    g = build_graph(src, dst, n, widths=widths)
    n_pad = shards.padded_nodes
    feat = rng.normal(size=(n, 10)).astype(np.float32)
    feat_pad = np.zeros((n_pad, 10), np.float32)
    feat_pad[:n] = feat

    model = ShardedGAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1),
                       attn_drop=p_drop)
    ref_model = GAT(num_layers=1, n_hidden=f, n_classes=3, heads=(h, 1),
                    attn_drop=p_drop)
    params = ref_model.init(jax.random.PRNGKey(0), 10)
    key = jax.random.PRNGKey(7)

    fwd = shard_map(
        lambda p, s, x: model.apply(p, local_view(s), x, training=True,
                                    key=key),
        mesh=mesh, in_specs=(P(), P("graph"), P("graph")),
        out_specs=P("graph"))
    out = jax.jit(fwd)(params, shards, jnp.asarray(feat_pad))
    ref = ref_model.apply(params, g, jnp.asarray(feat), training=True,
                          key=key)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_sharded_monet_matches_single(rng):
    """ShardedMoNet (halo all_to_all + resharded pseudo tables) vs the
    single-device binned MoNet: forward and gradients."""
    from dgnn.models import MoNet
    from dgnn.ops.gmm import bin_pseudo
    from dgnn.parallel import ShardedMoNet, shard_edge_data

    n, k, dim, num_shards = 40, 2, 3, 4
    src, dst = random_graph(rng, n, 4)
    mesh = _mesh(num_shards)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16))
    g = build_graph(src, dst, n, widths=(4, 16))
    n_pad = shards.padded_nodes

    feat = rng.normal(size=(n, 10)).astype(np.float32)
    feat_pad = np.zeros((n_pad, 10), np.float32)
    feat_pad[:n] = feat
    pseudo = jnp.asarray(rng.normal(size=(g.num_edges, 2)), jnp.float32)
    ptables = shard_edge_data(shards, pseudo)
    pbins = bin_pseudo(g, pseudo)
    mask_pad = np.zeros(n_pad, np.float32)
    mask_pad[:n] = 1.0

    model = ShardedMoNet(n_hidden=4, out_feats=3, n_layers=1, dim=dim,
                         n_kernels=k, dropout=0.0)
    ref_model = MoNet(n_hidden=4, out_feats=3, n_layers=1, dim=dim,
                      n_kernels=k, dropout=0.0)
    params = ref_model.init(jax.random.PRNGKey(2), 10, pbins)

    def per_shard(params, shards, pt, x):
        return model.apply(params, local_view(shards), x,
                           jax.tree.map(lambda v: v[0], pt))

    fwd = shard_map(per_shard, mesh=mesh,
                    in_specs=(P(), P("graph"), P("graph"), P("graph")),
                    out_specs=P("graph"))
    out = jax.jit(fwd)(params, shards, ptables, jnp.asarray(feat_pad))
    ref = ref_model.apply(params, g, jnp.asarray(feat), pbins)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=2e-4, atol=2e-5)

    def loss_sharded(params):
        o = fwd(params, shards, ptables, jnp.asarray(feat_pad))
        return jnp.sum(jnp.sin(o) * jnp.asarray(mask_pad)[:, None])

    def loss_ref(params):
        return jnp.sum(jnp.sin(ref_model.apply(params, g, jnp.asarray(feat),
                                               pbins)))

    gs = jax.jit(jax.grad(loss_sharded))(params)
    gr = jax.grad(loss_ref)(params)
    for a, b in zip(jax.tree.leaves(gs), jax.tree.leaves(gr)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)


def test_sharded_monet_node_pseudo_matches_single(rng):
    """Node-pseudo sharded MoNet (source scalars ride the halo payload;
    per-shard combine tables) vs the single-device gmm_aggregate_node path:
    forward and gradients."""
    from dgnn.models import MoNet
    from dgnn.ops.gmm import NodePseudo
    from dgnn.parallel import ShardedMoNet

    n, k, dim, num_shards = 48, 2, 2, 4
    src, dst = random_graph(rng, n, 6, power_law=True)
    mesh = _mesh(num_shards)
    shards = partition_graph(src, dst, n, num_shards, widths=(4, 16))
    g = build_graph(src, dst, n, widths=(4, 16))
    n_pad = shards.padded_nodes

    feat = rng.normal(size=(n, 10)).astype(np.float32)
    feat_pad = np.zeros((n_pad, 10), np.float32)
    feat_pad[:n] = feat
    psrc = rng.normal(size=(n, 1)).astype(np.float32)
    pdst = rng.normal(size=(n, 1)).astype(np.float32)
    psrc_pad = np.zeros((n_pad, 1), np.float32)
    psrc_pad[:n] = psrc
    pdst_pad = np.zeros((n_pad, 1), np.float32)
    pdst_pad[:n] = pdst
    mask_pad = np.zeros(n_pad, np.float32)
    mask_pad[:n] = 1.0

    model = ShardedMoNet(n_hidden=4, out_feats=3, n_layers=1, dim=dim,
                         n_kernels=k, dropout=0.0)
    ref_model = MoNet(n_hidden=4, out_feats=3, n_layers=1, dim=dim,
                      n_kernels=k, dropout=0.0)
    np_single = NodePseudo(src=jnp.asarray(psrc), dst=jnp.asarray(pdst))
    params = ref_model.init(jax.random.PRNGKey(2), 10, np_single)

    def per_shard(params, shards, ps, pd, x):
        return model.apply(params, local_view(shards), x,
                           NodePseudo(src=ps, dst=pd))

    fwd = shard_map(per_shard, mesh=mesh,
                    in_specs=(P(), P("graph"), P("graph"), P("graph"),
                              P("graph")),
                    out_specs=P("graph"))
    out = jax.jit(fwd)(params, shards, jnp.asarray(psrc_pad),
                       jnp.asarray(pdst_pad), jnp.asarray(feat_pad))
    ref = ref_model.apply(params, g, jnp.asarray(feat), np_single)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=2e-4, atol=2e-5)

    def loss_sharded(params):
        o = fwd(params, shards, jnp.asarray(psrc_pad), jnp.asarray(pdst_pad),
                jnp.asarray(feat_pad))
        return jnp.sum(jnp.sin(o) * jnp.asarray(mask_pad)[:, None])

    def loss_ref(params):
        return jnp.sum(jnp.sin(ref_model.apply(params, g, jnp.asarray(feat),
                                               np_single)))

    gs = jax.jit(jax.grad(loss_sharded))(params)
    gr = jax.grad(loss_ref)(params)
    flat_s = jax.tree_util.tree_leaves_with_path(gs)
    flat_r = {jax.tree_util.keystr(kk): v
              for kk, v in jax.tree_util.tree_leaves_with_path(gr)}
    for kk, v in flat_s:
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(flat_r[jax.tree_util.keystr(kk)]),
            rtol=2e-3, atol=2e-4, err_msg=jax.tree_util.keystr(kk))


def test_dgcnn_data_parallel_matches_single(rng):
    """DGCNN is batch-parallel: sharding the cloud batch over the mesh must
    reproduce single-device results (per-cloud compute is independent;
    BatchNorm in eval mode)."""
    from jax.sharding import NamedSharding
    from dgnn.models import DGCNN

    mesh = _mesh(4)
    b, p = 8, 16
    x = jnp.asarray(rng.normal(size=(b, p, 3)), jnp.float32)
    model = DGCNN(k=4, feature_dims=(8, 8), emb_dims=(16, 16),
                  output_classes=5, dropout=0.0)
    params, state = model.init(jax.random.PRNGKey(0))

    ref, _ = model.apply(params, state, x)

    xs = jax.device_put(x, NamedSharding(mesh, P("graph")))
    out, _ = jax.jit(lambda p, s, x: model.apply(p, s, x))(params, state, xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
