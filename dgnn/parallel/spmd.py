"""SPMD execution of row-partitioned GNN layers under `shard_map`.

The communication design (SURVEY.md §2.6): node features live sharded by
row range over the mesh axis; each layer sends exactly the statically-planned
boundary rows with ONE `lax.all_to_all` (NCCL, over NVLink between the cards
of a host), and local-source edges aggregate in parallel with the collective
— XLA's scheduler can overlap them because the local bin set has no data
dependency on the received halo.  Gradients flow back through the collective
automatically (all_to_all transposes to the reverse all_to_all), so remote
feature gradients return to their owning shard with no hand-written
reduction.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..graph.structure import BinnedAdj
from ..models.gat import GAT, GATConv
from ..models.monet import GMMConv, MoNet
from ..ops.gat import _gat_fused
from ..ops.gmm import NodePseudo, _gmm2, _gmm_node
from .partition import GraphShards

__all__ = ["local_view", "halo_exchange", "merge_binned", "shard_edge_data",
           "ShardedGATConv", "ShardedGAT", "ShardedGMMConv", "ShardedMoNet"]


def local_view(shards: GraphShards) -> GraphShards:
    """Strip the leading (sharded) axis inside shard_map blocks."""
    return jax.tree.map(lambda x: x[0], shards)


def merge_binned(a: BinnedAdj, b: BinnedAdj, cmb=None) -> BinnedAdj:
    """Union of two bin sets over the same destination rows (local + halo
    edge partitions combine through the segment log-sum-exp merge).

    ``cmb``: the shard's precomputed combine table
    (partition.GraphShards.fwd_cmb) — its positions cover a's bins ++ b's
    bins, exactly this merged adjacency's partial order."""
    assert a.num_rows == b.num_rows
    return BinnedAdj(nbr=a.nbr + b.nbr, edge=a.edge + b.edge, row=a.row + b.row,
                     count=a.count + b.count, cmb=cmb, epos=None,
                     widths=a.widths + b.widths, num_rows=a.num_rows,
                     num_edges=a.num_edges + b.num_edges)


def halo_exchange(x_local: jax.Array, send_ids: jax.Array, axis_name: str):
    """Exchange boundary rows: returns [C + P*Hmax, D] extended features.

    x_local: [C, D] this shard's rows; send_ids: [P, Hmax] local indices to
    send to each peer.  recv[q] arrives in exactly the requesting shard's
    halo-slot order (partition.py builds both sides from the same sorted
    request list), so extended index C + q*Hmax + j is recv[q, j].
    """
    send = x_local[send_ids]  # [P, Hmax, D]
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0, concat_axis=0)
    return jnp.concatenate([x_local, recv.reshape(-1, x_local.shape[-1])], 0)


def shard_edge_data(shards: GraphShards, data):
    """Reshard flat per-edge data [E, ...] (global CSR edge order) into each
    shard's binned slot tables, stacked on the shard axis.

    Returns (fwd_local_tables, fwd_halo_tables, bwd_tables) — tuples of
    [P, S, W, ...] arrays matching the shard's bin structure (strip the shard
    axis with local_view inside shard_map, like the rest of GraphShards).
    """
    local_flat = data[shards.edge_gids]  # [P, Emax, ...]
    take = jax.vmap(lambda lf, e: lf[e])

    def tables(adj: BinnedAdj):
        return tuple(take(local_flat, e) for e in adj.edge)

    return (tables(shards.fwd_local), tables(shards.fwd_halo),
            tables(shards.bwd))


def _varying(tree, axis_name):
    """Mark replicated parameters as varying over the mesh axis before they
    enter a custom_vjp op: the op's backward emits shard-local partial
    gradients, and the transpose of this cast psums them across shards."""
    return jax.tree.map(
        lambda v: jax.lax.pcast(v, axis_name, to="varying"), tree)


@dataclasses.dataclass(frozen=True)
class ShardedGATConv(GATConv):
    """GATConv over one graph shard (run under shard_map).

    Per layer: local dense projection -> one all_to_all of (features ++
    attn_col) boundary rows -> fused aggregation where local-source bins
    overlap the collective.  Parameters are GATConv's, so trees are
    interchangeable between single-device and sharded execution.
    """

    axis_name: str = "graph"

    def aggregate(self, local: GraphShards, attn_row, attn_col, x, *,
                  training, key):
        h, f = x.shape[1], x.shape[2]
        payload = jnp.concatenate([x.reshape(-1, h * f), attn_col], axis=-1)
        ext = halo_exchange(payload, local.send_ids, self.axis_name)
        feat_ext = ext[:, : h * f].reshape(-1, h, f)
        ac_ext = ext[:, h * f:]
        if training and self.attn_drop > 0.0:
            # same seed on every shard; pair_keep keys on GLOBAL ids
            # (ext_gids), so the sharded mask is bit-identical to single-chip
            seed = jax.random.bits(key, dtype=jnp.uint32)
        else:
            seed = jnp.uint32(0)
        adj_fwd = merge_binned(local.fwd_local, local.fwd_halo,
                               cmb=local.fwd_cmb)
        adj_bwd = dataclasses.replace(local.bwd, cmb=local.bwd_cmb)
        return _gat_fused(float(self.negative_slope), float(self.attn_drop),
                          bool(training), adj_fwd, adj_bwd, attn_row, ac_ext,
                          feat_ext, seed, local.ext_gids)


@dataclasses.dataclass(frozen=True)
class ShardedGAT(GAT):
    """Multi-layer sharded GAT with the same topology and parameter tree as
    models.GAT; ``apply`` takes the shard's ``local_view`` as its graph."""

    axis_name: str = "graph"

    conv_cls = ShardedGATConv

    def _conv_kwargs(self) -> dict:
        return dict(axis_name=self.axis_name)


@dataclasses.dataclass(frozen=True)
class ShardedGMMConv(GMMConv):
    """GMMConv over one graph shard (run under shard_map).

    Same communication shape as ShardedGATConv: local dense projection, ONE
    all_to_all of boundary rows, fused Gaussian-weighted aggregation over
    merged local+halo bins.  Two pseudo modes, mirroring models.GMMConv:

    - ``NodePseudo``: node-derived pseudo coordinates (the reference's
      citation protocol).  The source-side scalars ride the halo payload
      with the features (like attn_col in ShardedGATConv) so the projected
      alpha/beta are derivable per shard.
    - pseudo tables from ``shard_edge_data``: per-edge pseudo streams with
      the bins; no per-edge exchange is ever needed because edge data is
      owned by the destination shard.
    """

    axis_name: str = "graph"

    def aggregate(self, params, local: GraphShards, node_feat, pseudo):
        k, f = node_feat.shape[1], node_feat.shape[2]
        pw, pbias, mu, isig = _varying(
            (params["pseudo_w"], params["pseudo_b"], params["mu"],
             params["inv_sigma"]), self.axis_name)
        adj_fwd = merge_binned(local.fwd_local, local.fwd_halo,
                               cmb=local.fwd_cmb)
        adj_bwd = dataclasses.replace(local.bwd, cmb=local.bwd_cmb)
        if isinstance(pseudo, NodePseudo):
            # source scalars join the halo payload so every extended source
            # row carries its own
            ds = pseudo.src.shape[-1]
            payload = jnp.concatenate(
                [node_feat.reshape(-1, k * f),
                 pseudo.src.astype(node_feat.dtype)], axis=-1)
            ext = halo_exchange(payload, local.send_ids, self.axis_name)
            feat_ext = ext[:, : k * f].reshape(-1, k, f)
            sfeat_ext = ext[:, k * f:].astype(jnp.float32)
            return _gmm_node(True, adj_fwd, adj_bwd, sfeat_ext,
                             pseudo.dst.astype(jnp.float32), feat_ext,
                             pw[:ds], pw[ds:], pbias, mu, isig)
        feat_ext = halo_exchange(node_feat.reshape(-1, k * f), local.send_ids,
                                 self.axis_name).reshape(-1, k, f)
        pf_l, pf_h, pb = pseudo
        return _gmm2(True, adj_fwd, adj_bwd, pf_l + pf_h, pb, feat_ext, pw,
                     pbias, mu, isig)


@dataclasses.dataclass(frozen=True)
class ShardedMoNet(MoNet):
    """Multi-layer sharded MoNet with the same topology and parameter tree
    as models.MoNet (node-pseudo or ``shard_edge_data`` tables)."""

    axis_name: str = "graph"

    conv_cls = ShardedGMMConv

    def _conv_kwargs(self) -> dict:
        return dict(axis_name=self.axis_name)
