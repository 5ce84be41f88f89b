"""GMMConv (MoNet) layer and network (plain JAX).

Semantics mirror the reference layer (dgNN/layers/gmmconv_layer.py) and MoNet
(script/train/train_gmmconv.py:11-59): per-layer pseudo-coordinate projection
Linear(2, dim) + tanh, Gaussian-mixture edge weighting fused with SpMM, sum
over kernels.  Init: fc xavier-normal(relu gain), mu ~ N(0, 0.1),
inv_sigma = 1 (gmmconv_layer.py:43-49).

``pseudo`` takes one of three forms, and the parameters follow it:

- ``NodePseudo``: node-derived pseudo (the citation protocol); the
  projection runs inside the fused op (``pseudo_w``/``pseudo_b``).
- a tuple of pre-binned raw tables (``ops.gmm.bin_pseudo``); the projection
  also runs inside the fused op.
- a flat [E, D] array; MoNet projects it per layer (``pseudo_proj_i``)
  before the op.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops.gmm import (NodePseudo, gmm_aggregate, gmm_aggregate_binned,
                       gmm_aggregate_node)
from .layers import dense_apply, dense_init, dropout, lecun_normal, \
    xavier_normal

__all__ = ["GMMConv", "MoNet", "pseudo_in_dim"]


def pseudo_in_dim(pseudo) -> int:
    """Raw pseudo width the layer projects itself (0 for a flat array,
    which MoNet projects before the layer)."""
    if isinstance(pseudo, NodePseudo):
        return pseudo.src.shape[-1] + pseudo.dst.shape[-1]
    if isinstance(pseudo, tuple):
        return pseudo[0][0].shape[-1]
    return 0


@dataclasses.dataclass(frozen=True)
class GMMConv:
    """Gaussian-mixture model convolution. Output: [N, out_feats]."""

    in_feats: int
    out_feats: int
    dim: int
    n_kernels: int
    pseudo_in: int = 0  # raw pseudo width projected inside the op (0: none)
    residual: bool = False
    use_bias: bool = True
    gather_dtype: object = None  # e.g. "bfloat16": halve gathered rows

    def init(self, key) -> dict:
        k, f = self.n_kernels, self.out_feats
        kf, km, kp, kr = jax.random.split(key, 4)
        p = {"fc": xavier_normal()(kf, (self.in_feats, k * f), jnp.float32),
             "mu": 0.1 * jax.random.normal(km, (k, self.dim), jnp.float32),
             "inv_sigma": jnp.ones((k, self.dim), jnp.float32)}
        if self.pseudo_in:
            p["pseudo_w"] = lecun_normal()(kp, (self.pseudo_in, self.dim),
                                           jnp.float32)
            p["pseudo_b"] = jnp.zeros((self.dim,), jnp.float32)
        if self.residual and self.in_feats != f:
            p["res_fc"] = xavier_normal()(kr, (self.in_feats, f),
                                          jnp.float32)
        if self.use_bias:
            p["bias"] = jnp.zeros((f,), jnp.float32)
        return p

    def aggregate(self, params, graph, node_feat, pseudo):
        """Sparse part of the layer -> [N, K, F]; sharded layers override
        this."""
        mu, isig = params["mu"], params["inv_sigma"]
        if isinstance(pseudo, NodePseudo):
            gd = (jnp.dtype(self.gather_dtype)
                  if self.gather_dtype is not None else None)
            return gmm_aggregate_node(graph, node_feat, pseudo.src,
                                      pseudo.dst, mu, isig,
                                      proj_weight=params["pseudo_w"],
                                      proj_bias=params["pseudo_b"],
                                      use_tanh=True, gather_dtype=gd)
        if isinstance(pseudo, tuple):
            return gmm_aggregate_binned(graph, node_feat, pseudo, mu, isig,
                                        proj_weight=params["pseudo_w"],
                                        proj_bias=params["pseudo_b"],
                                        use_tanh=True)
        return gmm_aggregate(graph, node_feat, pseudo, mu, isig)

    def apply(self, params, graph, feat, pseudo):
        k, f = self.n_kernels, self.out_feats
        node_feat = (feat @ params["fc"]).reshape(-1, k, f)
        rst = self.aggregate(params, graph, node_feat, pseudo)
        rst = jnp.sum(rst, axis=1)  # sum over kernels (gmmconv_layer.py:58)
        if self.residual:
            rst = rst + (feat @ params["res_fc"] if "res_fc" in params
                         else feat)
        if self.use_bias:
            rst = rst + params["bias"]
        return rst


@dataclasses.dataclass(frozen=True)
class MoNet:
    """MoNet stack with per-layer pseudo projections and inter-layer dropout
    (reference MoNet.forward, train_gmmconv.py:52-59)."""

    n_hidden: int
    out_feats: int
    n_layers: int
    dim: int
    n_kernels: int
    dropout: float = 0.5
    gather_dtype: object = None

    conv_cls = GMMConv

    def _conv_kwargs(self) -> dict:
        return dict(gather_dtype=self.gather_dtype)

    def layers(self, in_feats: int, pseudo_in: int):
        dims = [self.n_hidden] * self.n_layers + [self.out_feats]
        out, d = [], in_feats
        for i, o in enumerate(dims):
            out.append((f"gmm_{i}", self.conv_cls(
                in_feats=d, out_feats=o, dim=self.dim,
                n_kernels=self.n_kernels, pseudo_in=pseudo_in,
                **self._conv_kwargs())))
            d = o
        return out

    def init(self, key, in_feats: int, pseudo) -> dict:
        layers = self.layers(in_feats, pseudo_in_dim(pseudo))
        keys = jax.random.split(key, 2 * len(layers))
        params = {}
        for i, (name, conv) in enumerate(layers):
            params[name] = conv.init(keys[2 * i])
            if not pseudo_in_dim(pseudo):
                params[f"pseudo_proj_{i}"] = dense_init(
                    keys[2 * i + 1], pseudo.shape[-1], self.dim)
        return params

    def apply(self, params, graph, feat, pseudo, *, training: bool = False,
              key=None):
        layers = self.layers(feat.shape[-1], pseudo_in_dim(pseudo))
        keys = (jax.random.split(key, len(layers)) if key is not None
                else [None] * len(layers))
        h = feat
        for i, ((name, conv), k) in enumerate(zip(layers, keys)):
            if i != 0:
                h = dropout(h, self.dropout, k, training)
            p = pseudo
            if not pseudo_in_dim(pseudo):
                p = jnp.tanh(dense_apply(params[f"pseudo_proj_{i}"], pseudo))
            h = conv.apply(params[name], graph, h, p)
        return h
