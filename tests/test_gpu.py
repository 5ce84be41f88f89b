"""Card-only checks: skip without an NVIDIA GPU.  chip_smoke.py covers the
same ground at real widths on every chip run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgnn.graph.structure import build_graph
from dgnn.ops import reference
from dgnn.ops.gat import gat_aggregate
from dgnn.utils import device_peak_memory_mb
from tests.conftest import random_graph

pytestmark = pytest.mark.gpu


def test_peak_memory_reported(gpu):
    x = jax.device_put(jnp.ones((1024, 1024)), gpu)
    jax.block_until_ready(x * 2)
    assert device_peak_memory_mb(gpu) >= 4.0


def test_gat_aggregate_on_gpu_matches_dense(gpu, rng):
    """The fused op compiled for the card vs the dense oracle at "highest"
    precision; tolerance for TF32 products."""
    n, h, f = 300, 4, 64
    src, dst = random_graph(rng, n, 20, power_law=True)
    g = build_graph(src, dst, n)
    ar = jnp.asarray(rng.normal(size=(n, h)), jnp.float32)
    ac = jnp.asarray(rng.normal(size=(n, h)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(n, h, f)), jnp.float32)
    adj = reference.dense_adj(np.asarray(g.row_ptr), np.asarray(g.col_ind), n)
    out = jax.jit(lambda a, b, c: gat_aggregate(g, a, b, c))(ar, ac, x)
    with jax.default_matmul_precision("highest"):
        ref, _, _ = reference.gat_dense(adj, ar, ac, x, 0.2)
    assert float(jnp.max(jnp.abs(out - ref))) <= 2e-3 * float(
        jnp.max(jnp.abs(ref)))
