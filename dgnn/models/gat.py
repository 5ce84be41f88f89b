"""GAT layer and network (plain JAX: ``init(key, in_feats) -> params``,
``apply(params, graph, feat, *, training, key)``).

Semantics mirror the reference layer (dgNN/layers/gatconv_layer.py) and
multi-layer Net (script/train/train_gatconv.py:11-53): dense projection and
attention-coefficient reduction in plain matmuls, everything sparse in the
fused `gat_aggregate` op.  Init follows the reference's xavier-normal with
relu gain (gatconv_layer.py:58-66).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..ops.gat import gat_aggregate
from ..ops.naive import gat_naive
from .layers import dropout, xavier_normal

__all__ = ["GATConv", "GAT"]


@dataclasses.dataclass(frozen=True)
class GATConv:
    """Multi-head graph attention layer over a fused sparse aggregation.

    Output: [N, num_heads, out_feats].
    """

    in_feats: int
    out_feats: int
    num_heads: int
    feat_drop: float = 0.0
    attn_drop: float = 0.0
    negative_slope: float = 0.2
    residual: bool = False
    activation: Optional[Callable] = None
    use_bias: bool = True
    impl: str = "fused"  # "fused" (binned) | "naive" (DGL-style)
    gather_dtype: Optional[str] = None  # e.g. "bfloat16": halve gathered rows

    def init(self, key) -> dict:
        h, f = self.num_heads, self.out_feats
        kw, kl, kr, kres = jax.random.split(key, 4)
        init = xavier_normal()
        p = {"W": init(kw, (self.in_feats, h * f), jnp.float32),
             "attn_l": init(kl, (1, h, f), jnp.float32),
             "attn_r": init(kr, (1, h, f), jnp.float32)}
        if self.residual and self.in_feats != h * f:
            p["res_fc"] = init(kres, (self.in_feats, h * f), jnp.float32)
        if self.use_bias:
            p["bias"] = jnp.zeros((1, h, f), jnp.float32)
        return p

    def aggregate(self, graph, attn_row, attn_col, x, *, training, key):
        """Sparse part of the layer; sharded layers override this."""
        if self.impl == "naive":
            return gat_naive(graph, attn_row, attn_col, x,
                             negative_slope=self.negative_slope,
                             attn_drop=self.attn_drop, key=key,
                             training=training)
        gd = (jnp.dtype(self.gather_dtype) if self.gather_dtype is not None
              else None)
        return gat_aggregate(graph, attn_row, attn_col, x,
                             negative_slope=self.negative_slope,
                             attn_drop=self.attn_drop, key=key,
                             training=training, gather_dtype=gd)

    def apply(self, params, graph, feat, *, training: bool = False,
              key=None):
        h, f = self.num_heads, self.out_feats
        k_feat, k_attn = (jax.random.split(key) if key is not None
                          else (None, None))
        x = (feat @ params["W"]).reshape(-1, h, f)
        x = dropout(x, self.feat_drop, k_feat, training)
        attn_row = jnp.sum(params["attn_l"] * x, axis=-1)  # [N, H] dst
        attn_col = jnp.sum(params["attn_r"] * x, axis=-1)  # [N, H] src
        rst = self.aggregate(graph, attn_row, attn_col, x, training=training,
                             key=k_attn)
        if self.residual:
            res = feat @ params["res_fc"] if "res_fc" in params else feat
            rst = rst + res.reshape(-1, h, f)
        if self.use_bias:
            rst = rst + params["bias"]
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


@dataclasses.dataclass(frozen=True)
class GAT:
    """Multi-layer GAT: `num_layers` hidden layers with `heads[l]` heads whose
    outputs are flattened, then an output layer averaged over its heads
    (reference Net.forward, train_gatconv.py:47-53)."""

    num_layers: int
    n_hidden: int
    n_classes: int
    heads: Sequence[int]
    feat_drop: float = 0.0
    attn_drop: float = 0.0
    negative_slope: float = 0.2
    residual: bool = False
    activation: Optional[Callable] = None
    impl: str = "fused"
    gather_dtype: Optional[str] = None

    conv_cls = GATConv

    def _conv_kwargs(self) -> dict:
        return dict(impl=self.impl, gather_dtype=self.gather_dtype)

    def layers(self, in_feats: int):
        """[(name, GATConv)] in execution order."""
        out, d = [], in_feats
        common = dict(feat_drop=self.feat_drop, attn_drop=self.attn_drop,
                      negative_slope=self.negative_slope,
                      **self._conv_kwargs())
        for layer in range(self.num_layers):
            conv = self.conv_cls(
                in_feats=d, out_feats=self.n_hidden,
                num_heads=self.heads[layer], residual=self.residual,
                activation=self.activation,
                use_bias=layer > 0,  # reference: input projection bias=False
                **common)
            out.append((f"gat_{layer}", conv))
            d = self.n_hidden * self.heads[layer]
        out.append(("gat_out", self.conv_cls(
            in_feats=d, out_feats=self.n_classes, num_heads=self.heads[-1],
            **common)))
        return out

    def init(self, key, in_feats: int) -> dict:
        layers = self.layers(in_feats)
        keys = jax.random.split(key, len(layers))
        return {name: conv.init(k) for (name, conv), k in zip(layers, keys)}

    def apply(self, params, graph, feat, *, training: bool = False,
              key=None):
        layers = self.layers(feat.shape[-1])
        keys = (jax.random.split(key, len(layers)) if key is not None
                else [None] * len(layers))
        h = feat
        for (name, conv), k in zip(layers, keys):
            h = conv.apply(params[name], graph, h, training=training, key=k)
            if name != "gat_out":
                h = h.reshape(h.shape[0], -1)
        return jnp.mean(h, axis=1)
