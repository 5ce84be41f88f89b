"""Native (C++) preprocessing vs the pure-numpy reference implementations."""

import numpy as np
import pytest

from tests.conftest import random_graph


def _numpy_csr(src, dst, n):
    order = np.lexsort((src, dst))
    col_ind = src[order].astype(np.int32)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    return row_ptr, col_ind


def _numpy_csc(row_ptr, col_ind, n):
    row_of_edge = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(row_ptr).astype(np.int64))
    order = np.lexsort((row_of_edge, col_ind.astype(np.int64)))
    col_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(col_ind, minlength=n), out=col_ptr[1:])
    return col_ptr, row_of_edge[order].astype(np.int32), order.astype(np.int32)


@pytest.fixture(scope="module")
def native():
    from dgnn import native as nat

    if not nat.available():
        pytest.skip("native library unavailable (no g++?)")
    return nat


def test_native_coo_to_csr(rng, native):
    n = 500
    src, dst = random_graph(rng, n, 10)
    rp, ci = native.coo_to_csr(src, dst, n)
    rp0, ci0 = _numpy_csr(src, dst, n)
    np.testing.assert_array_equal(rp, rp0)
    np.testing.assert_array_equal(ci, ci0)


def test_native_csc_permute(rng, native):
    n = 300
    src, dst = random_graph(rng, n, 8)
    rp, ci = native.coo_to_csr(src, dst, n)
    cp, ri, perm = native.csr_to_csc_permute(rp, ci)
    cp0, ri0, perm0 = _numpy_csc(rp, ci, n)
    np.testing.assert_array_equal(cp, cp0)
    np.testing.assert_array_equal(ri, ri0)
    np.testing.assert_array_equal(perm, perm0)


def test_native_rmat_shape_and_determinism(native):
    s1, d1 = native.rmat_edges(1000, 5000, seed=42)
    s2, d2 = native.rmat_edges(1000, 5000, seed=42)
    assert s1.shape == (5000,)
    assert (0 <= s1).all() and (s1 < 1000).all()
    assert (0 <= d1).all() and (d1 < 1000).all()
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    # power law: top-1% in-degree nodes should hold a large edge share
    deg = np.bincount(d1, minlength=1000)
    top = np.sort(deg)[-10:].sum()
    assert top > 0.05 * 5000, top


def test_native_bin_fill_matches_numpy(rng, native):
    """The native slot-table fill equals the numpy path of binning._build_bin
    (padded slots zero, valid slots the CSR neighbours and edge ids)."""
    s, width = 37, 8
    counts = rng.integers(0, width + 1, s).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    col_ind = rng.integers(0, 1000, int(counts.sum())).astype(np.int32)
    edge_ids = rng.permutation(len(col_ind)).astype(np.int64)
    nbr, edge = native.bin_fill(starts, counts, width, col_ind, edge_ids)
    lane = np.arange(width)[None, :]
    mask = lane < counts[:, None]
    offs = np.where(mask, starts[:, None] + lane, 0)
    np.testing.assert_array_equal(nbr, np.where(mask, col_ind[offs], 0))
    np.testing.assert_array_equal(edge, np.where(mask, edge_ids[offs], 0))
