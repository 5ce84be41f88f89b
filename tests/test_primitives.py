"""Standalone sparse primitives (spmm/sddmm/edge_softmax/edge_transpose) vs
dense oracles, including gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgnn.graph.structure import build_graph
from dgnn.ops import edge_softmax, edge_transpose, reference, sddmm, spmm
from tests.conftest import random_graph


def _setup(rng, n=50, deg=4, h=2, f=5):
    src, dst = random_graph(rng, n, deg)
    g = build_graph(src, dst, n, widths=(4, 16))
    eid = reference.dense_edge_ids(np.asarray(g.row_ptr), np.asarray(g.col_ind), n)
    return g, eid


def test_spmm_matches_dense_and_grads(rng):
    g, eid = _setup(rng)
    n, h, f = g.num_nodes, 2, 5
    w = jnp.asarray(rng.normal(size=(g.num_edges, h)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(n, h, f)), jnp.float32)

    def dense(w, x):
        wd = jnp.where(jnp.asarray(eid)[..., None] >= 0,
                       w[jnp.maximum(jnp.asarray(eid), 0)], 0.0)  # [N,N,H]
        return jnp.einsum("dsh,shf->dhf", wd, x)

    out = spmm(g, w, x)
    np.testing.assert_allclose(out, dense(w, x), rtol=1e-5, atol=1e-5)

    gw, gx = jax.grad(lambda w, x: jnp.sum(spmm(g, w, x) ** 2),
                      argnums=(0, 1))(w, x)
    gw0, gx0 = jax.grad(lambda w, x: jnp.sum(dense(w, x) ** 2),
                        argnums=(0, 1))(w, x)
    np.testing.assert_allclose(gw, gw0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx, gx0, rtol=1e-4, atol=1e-5)


def test_sddmm_matches_dense_and_grads(rng):
    g, eid = _setup(rng)
    n, h, f = g.num_nodes, 3, 4
    a = jnp.asarray(rng.normal(size=(n, h, f)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(n, h, f)), jnp.float32)
    row_ptr = np.asarray(g.row_ptr)
    col_ind = np.asarray(g.col_ind)
    rows = np.repeat(np.arange(n), np.diff(row_ptr))

    def dense(a, b):
        return jnp.einsum("ehf,ehf->eh", a[jnp.asarray(rows)],
                          b[jnp.asarray(col_ind)])

    out = sddmm(g, a, b)
    np.testing.assert_allclose(out, dense(a, b), rtol=1e-5, atol=1e-5)

    ga, gb = jax.grad(lambda a, b: jnp.sum(jnp.sin(sddmm(g, a, b))),
                      argnums=(0, 1))(a, b)
    ga0, gb0 = jax.grad(lambda a, b: jnp.sum(jnp.sin(dense(a, b))),
                        argnums=(0, 1))(a, b)
    np.testing.assert_allclose(ga, ga0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb, gb0, rtol=1e-4, atol=1e-5)


def test_edge_softmax_rows_sum_to_one(rng):
    g, _ = _setup(rng)
    scores = jnp.asarray(rng.normal(size=(g.num_edges, 2)), jnp.float32)
    a = edge_softmax(g, scores)
    row_ptr = np.asarray(g.row_ptr)
    a_np = np.asarray(a)
    for i in range(g.num_nodes):
        seg = a_np[row_ptr[i]:row_ptr[i + 1]]
        if len(seg):
            np.testing.assert_allclose(seg.sum(0), 1.0, rtol=1e-5)


def test_edge_transpose_roundtrip(rng):
    g, _ = _setup(rng)
    data = jnp.asarray(rng.normal(size=(g.num_edges, 3)), jnp.float32)
    t = edge_transpose(g, data)
    # CSC slot j holds CSR edge permute[j]
    np.testing.assert_allclose(np.asarray(t),
                               np.asarray(data)[np.asarray(g.permute)])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pack_rows_keeps_scalars_exact(rng, dtype):
    """Gather tables carry features in the gather dtype and float32 scalar
    columns bit-exactly, whatever the table dtype."""
    from dgnn.ops.common import pack_rows, unpack_scalars

    feat = jnp.asarray(rng.normal(size=(7, 3, 4)), jnp.float32).astype(dtype)
    a = jnp.asarray(rng.normal(size=(7, 3)) * 1e3, jnp.float32)
    b = jnp.asarray(rng.normal(size=(7, 1)) * 1e-3, jnp.float32)
    z = pack_rows(feat, a, b)
    assert z.dtype == dtype
    idx = jnp.asarray([[6, 0], [2, 2]])
    g = z[idx]  # gathered [2, 2, C]
    sc = unpack_scalars(g, 12)
    np.testing.assert_array_equal(sc, jnp.concatenate([a, b], 1)[idx])
    np.testing.assert_array_equal(g[..., :12], feat.reshape(7, 12)[idx])
