"""EdgeConv layer and DGCNN point-cloud classifier (plain JAX).

Semantics mirror the reference layer (dgNN/layers/edgeconv_layer.py) and
Model (script/train/train_edgeconv.py:12-70): the k-NN graph is rebuilt from
features before every EdgeConv (here fully on device, graph/knn.py), layer
outputs are concatenated, projected, max+mean pooled, then an MLP head.

BatchNorm running statistics live in a ``state`` pytree beside the params:
``init(key) -> (params, state)`` and
``apply(params, state, x, *, training, key) -> (logits, new_state)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from ..graph.knn import knn_mask_neg
from ..ops.edgeconv import edge_conv_max, edge_conv_max_dense
from .layers import (batch_norm_apply, batch_norm_init, dense_apply,
                     dense_init, dropout)

__all__ = ["EdgeConv", "DGCNN"]


@dataclasses.dataclass(frozen=True)
class EdgeConv:
    """theta/phi formulation: out[i] = max_j (phi(x_i) + theta(x_j - x_i)),
    computed as max_j(h_dst[i] + h_src[j]) with h_src = theta(x),
    h_dst = phi(x) - theta(x) (edgeconv_layer.py:34-41).

    ``adj`` is either an explicit [N, k] neighbor-id table (gather path,
    reference-API parity) or a dense [B, P, P] additive mask with [B, P, C]
    features (the performance path — see ops/edgeconv.py)."""

    in_feat: int
    out_feat: int

    def init(self, key) -> dict:
        kt, kp = jax.random.split(key)
        return {"theta": dense_init(kt, self.in_feat, self.out_feat, False),
                "phi": dense_init(kp, self.in_feat, self.out_feat, False)}

    def apply(self, params, adj, feat):
        h_theta = dense_apply(params["theta"], feat)
        h_phi = dense_apply(params["phi"], feat)
        if adj.ndim == 3:
            return edge_conv_max_dense(adj, h_theta, h_phi - h_theta)
        return edge_conv_max(adj, h_theta, h_phi - h_theta)


@dataclasses.dataclass(frozen=True)
class DGCNN:
    """Dynamic graph CNN for point-cloud classification (reference Model,
    train_edgeconv.py:12-70; defaults from :243)."""

    k: int = 40
    feature_dims: Sequence[int] = (64, 64, 128, 256)
    emb_dims: Sequence[int] = (512, 512, 256)
    output_classes: int = 40
    dropout: float = 0.5
    in_dim: int = 3

    def _convs(self):
        dims = [self.in_dim] + list(self.feature_dims)
        return [EdgeConv(dims[i], dims[i + 1])
                for i in range(len(self.feature_dims))]

    def init(self, key):
        """Returns (params, state)."""
        n_emb = len(self.emb_dims)
        keys = jax.random.split(key, len(self.feature_dims) + n_emb + 1)
        params, state = {}, {}
        for i, conv in enumerate(self._convs()):
            params[f"conv_{i}"] = conv.init(keys[i])
        ko = len(self.feature_dims)
        params["proj"] = dense_init(keys[ko], sum(self.feature_dims),
                                    self.emb_dims[0])
        d = 2 * self.emb_dims[0]
        for i in range(1, n_emb):
            params[f"emb_{i}"] = dense_init(keys[ko + i], d, self.emb_dims[i])
            params[f"bn_{i}"], state[f"bn_{i}"] = batch_norm_init(
                self.emb_dims[i])
            d = self.emb_dims[i]
        params["head"] = dense_init(keys[-1], d, self.output_classes)
        return params, state

    def apply(self, params, state, x, *, training: bool = False, key=None):
        """Returns (logits, new_state); the state changes only in
        training."""
        hs = []
        h = x
        for i, conv in enumerate(self._convs()):
            # dynamic graph from current features, as a dense per-cloud mask;
            # graph construction is not differentiated (reference likewise),
            # and stop_gradient keeps AD from building a backward path
            # through the top_k / distance matrix
            mask = jax.lax.stop_gradient(knn_mask_neg(h, self.k))
            h = jax.nn.leaky_relu(conv.apply(params[f"conv_{i}"], mask, h),
                                  negative_slope=0.2)
            hs.append(h)
        h = dense_apply(params["proj"], jnp.concatenate(hs, axis=-1))
        h = jnp.concatenate([jnp.max(h, axis=1), jnp.mean(h, axis=1)],
                            axis=-1)
        keys = (jax.random.split(key, len(self.emb_dims)) if key is not None
                else [None] * len(self.emb_dims))
        new_state = dict(state)
        for i in range(1, len(self.emb_dims)):
            h = dense_apply(params[f"emb_{i}"], h)
            h, new_state[f"bn_{i}"] = batch_norm_apply(
                params[f"bn_{i}"], state[f"bn_{i}"], h, training=training)
            h = jax.nn.leaky_relu(h, negative_slope=0.2)
            h = dropout(h, self.dropout, keys[i], training)
        return dense_apply(params["head"], h), new_state
