"""Parameter initialisers and stateless layer helpers shared by the models.

Every model is a frozen dataclass of hyper-parameters with
``init(key, ...) -> params`` and ``apply(params, ..., training, key)``;
parameters are nested dicts of arrays, so optax, ``jax.tree`` and the
``.npz`` checkpoints (utils/checkpoint.py) take them as they are.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["xavier_normal", "lecun_normal", "dense_init", "dense_apply",
           "dropout", "batch_norm_init", "batch_norm_apply"]

_GAIN_RELU = float(np.sqrt(2.0))

lecun_normal = jax.nn.initializers.lecun_normal


def xavier_normal(gain: float = _GAIN_RELU):
    return jax.nn.initializers.variance_scaling(gain * gain, "fan_avg",
                                                "normal")


def dense_init(key, in_feats: int, out_feats: int,
               use_bias: bool = True) -> dict:
    """Dense layer ``x @ kernel (+ bias)``: lecun-normal kernel, zero bias."""
    p = {"kernel": lecun_normal()(key, (in_feats, out_feats), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_feats,), jnp.float32)
    return p


def dense_apply(p: dict, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def dropout(x, rate: float, key, training: bool):
    """Inverted dropout; identity when not training or ``rate == 0``."""
    if not training or rate <= 0.0:
        return x
    if key is None:
        raise ValueError("dropout in training requires a PRNG key")
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0)


def batch_norm_init(features: int):
    """(params, state) of a batch norm over the last axis."""
    params = {"scale": jnp.ones((features,), jnp.float32),
              "bias": jnp.zeros((features,), jnp.float32)}
    state = {"mean": jnp.zeros((features,), jnp.float32),
             "var": jnp.ones((features,), jnp.float32)}
    return params, state


def batch_norm_apply(params, state, x, *, training: bool,
                     momentum: float = 0.99, eps: float = 1e-5):
    """Batch norm over every axis but the last.  Training normalises by the
    batch statistics and returns running statistics updated with
    ``momentum``; inference uses the running statistics unchanged.
    Returns (y, new_state)."""
    if training:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axis=axes)
        var = jnp.maximum(jnp.mean(x * x, axis=axes) - mean * mean, 0.0)
        state = {"mean": momentum * state["mean"] + (1 - momentum) * mean,
                 "var": momentum * state["var"] + (1 - momentum) * var}
    else:
        mean, var = state["mean"], state["var"]
    y = (x - mean) * jax.lax.rsqrt(var + eps)
    return y * params["scale"] + params["bias"], state
