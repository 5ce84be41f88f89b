"""Test config: the CPU backend with a virtual 8-device mesh, so sharding
logic is exercised without accelerators (SURVEY.md §4 implication).

JAX_PLATFORMS, when set, wins: tests marked ``gpu`` run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]


def random_graph(rng, num_nodes, avg_degree, power_law=False):
    """Random COO edge list, deduplicated (multi-edges are legal in the
    framework but inexpressible in the dense [N, N] test oracles)."""
    num_edges = int(num_nodes * avg_degree)
    src = rng.integers(0, num_nodes, num_edges)
    if power_law:
        # skew destinations: a few hubs with large in-degree to exercise
        # multi-bin + mega-row splitting
        z = rng.zipf(1.6, num_edges)
        dst = np.minimum(z - 1, num_nodes - 1)
    else:
        dst = rng.integers(0, num_nodes, num_edges)
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    return uniq[:, 0].astype(np.int64), uniq[:, 1].astype(np.int64)
