"""Graph preprocessing tests: CSR/CSC/permute vs scipy, binning integrity."""

import numpy as np
import pytest
import scipy.sparse as sp

from dgnn.graph import binning, build
from dgnn.graph.structure import build_graph
from tests.conftest import random_graph


def _scipy_reference(src, dst, n):
    """Reference construction mirroring dgNN train_gatconv.py:78-94."""
    e = np.arange(len(src))
    csr = sp.csr_matrix((e, (dst, src)), shape=(n, n))
    csc = csr.tocsc()
    csr2 = sp.csr_matrix((e, csr.indices, csr.indptr), shape=(n, n))
    permute = csr2.tocsc().data
    return csr.indptr, csr.indices, csc.indptr, csc.indices, permute


@pytest.mark.parametrize("n,deg", [(50, 3), (200, 8)])
def test_csr_csc_permute_vs_scipy(rng, n, deg):
    src, dst = random_graph(rng, n, deg)
    # dedupe so scipy csr_matrix doesn't sum duplicate entries
    uniq = np.unique(np.stack([src, dst], 1), axis=0)
    src, dst = uniq[:, 0], uniq[:, 1]
    row_ptr, col_ind = build.coo_to_csr(src, dst, n)
    col_ptr, row_ind, permute = build.csr_to_csc_permute(row_ptr, col_ind)
    sp_rp, sp_ci, sp_cp, sp_ri, sp_perm = _scipy_reference(src, dst, n)
    np.testing.assert_array_equal(row_ptr, sp_rp)
    np.testing.assert_array_equal(col_ind, sp_ci)
    np.testing.assert_array_equal(col_ptr, sp_cp)
    np.testing.assert_array_equal(row_ind, sp_ri)
    np.testing.assert_array_equal(permute, sp_perm)


def test_permute_contract(rng):
    """permute[j] is the CSR edge id of CSC slot j: the edge endpoints match."""
    n = 120
    src, dst = random_graph(rng, n, 5)
    row_ptr, col_ind = build.coo_to_csr(src, dst, n)
    col_ptr, row_ind, permute = build.csr_to_csc_permute(row_ptr, col_ind)
    csr_row = np.repeat(np.arange(n), np.diff(row_ptr))
    # CSC slot j belongs to column c and destination row_ind[j];
    # CSR edge permute[j] must connect the same (dst, src) pair.
    csc_col = np.repeat(np.arange(n), np.diff(col_ptr))
    np.testing.assert_array_equal(csr_row[permute], row_ind)
    np.testing.assert_array_equal(col_ind[permute], csc_col)


@pytest.mark.parametrize("widths", [(4,), (2, 8), (4, 16, 64)])
def test_binning_roundtrip(rng, widths):
    """Every (row, neighbor, edge-id) triple appears exactly once in the bins."""
    n = 150
    src, dst = random_graph(rng, n, 6, power_law=True)
    row_ptr, col_ind = build.coo_to_csr(src, dst, n)
    b = binning.bin_csr(row_ptr, col_ind, widths=widths)
    seen = []
    for i, w in enumerate(b.widths):
        count = b.count[i]
        for s in range(b.nbr[i].shape[0]):
            c = count[s]
            for j in range(c):
                seen.append((b.row[i][s], b.nbr[i][s, j], b.edge[i][s, j]))
    assert len(seen) == len(col_ind)
    expect = set()
    csr_row = np.repeat(np.arange(n), np.diff(row_ptr))
    for e in range(len(col_ind)):
        expect.add((csr_row[e], col_ind[e], e))
    assert set(seen) == expect


def test_binning_splits_mega_rows(rng):
    n = 64
    # one hub with degree 100 (all nodes point at node 0 multiple times)
    src = np.tile(np.arange(50), 2)
    dst = np.zeros(100, dtype=np.int64)
    row_ptr, col_ind = build.coo_to_csr(src, dst, n)
    b = binning.bin_csr(row_ptr, col_ind, widths=(8, 32))
    widest = b.widths.index(32)
    segs_for_row0 = (b.row[widest] == 0) & (b.count[widest] > 0)
    assert segs_for_row0.sum() == 4  # ceil(100/32)
    assert b.count[widest][segs_for_row0].sum() == 100


def test_build_graph_self_loops(rng):
    n = 40
    src, dst = random_graph(rng, n, 4)
    g = build_graph(src, dst, n)
    # every node got exactly one self loop
    row_ptr = np.asarray(g.row_ptr)
    col_ind = np.asarray(g.col_ind)
    for i in range(n):
        nbrs = col_ind[row_ptr[i]:row_ptr[i + 1]]
        assert (nbrs == i).sum() == 1
    assert g.fwd.num_edges == g.num_edges
    assert g.bwd.num_edges == g.num_edges


def test_bwd_bins_carry_csr_edge_ids(rng):
    """Transposed-layout bins must store *global CSR* edge ids (permute)."""
    n = 60
    src, dst = random_graph(rng, n, 5)
    g = build_graph(src, dst, n)
    col_ind = np.asarray(g.col_ind)
    row_ptr = np.asarray(g.row_ptr)
    csr_row = np.repeat(np.arange(n), np.diff(row_ptr))
    for i in range(g.bwd.num_bins):
        nbr = np.asarray(g.bwd.nbr[i])
        edge = np.asarray(g.bwd.edge[i])
        row = np.asarray(g.bwd.row[i])
        count = np.asarray(g.bwd.count[i])
        for s in range(nbr.shape[0]):
            for j in range(count[s]):
                e = edge[s, j]
                assert col_ind[e] == row[s]      # CSR source = bwd bin row
                assert csr_row[e] == nbr[s, j]   # CSR dest = bwd slot nbr


def test_auto_widths_minimizes_padding(rng):
    from dgnn.graph.binning import auto_widths, bin_csr, DEFAULT_WIDTHS
    import numpy as np

    # low-degree graph: auto widths should waste fewer slots than defaults
    deg = rng.integers(1, 6, 500)
    ptr = np.zeros(501, np.int64)
    np.cumsum(deg, out=ptr[1:])
    col = rng.integers(0, 500, int(ptr[-1])).astype(np.int32)
    w = auto_widths(deg)
    assert all(x in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) for x in w)
    b_auto = bin_csr(ptr, col, widths=w)
    b_def = bin_csr(ptr, col, widths=DEFAULT_WIDTHS)
    assert b_auto.fill_ratio() >= b_def.fill_ratio()
    assert b_auto.fill_ratio() > 0.55


def test_auto_widths_mega_rows(rng):
    from dgnn.graph.binning import auto_widths

    deg = np.concatenate([np.full(100, 3), [5000, 20000]])
    w = auto_widths(deg)
    # top width must bound segments-per-row (combine-table width)
    assert -(-20000 // w[-1]) <= 8 and len(w) <= 6
