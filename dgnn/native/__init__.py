"""ctypes bindings for the native graph-preprocessing library.

Compiled on demand with g++ (no pip deps); falls back silently to the numpy
implementations in graph/build.py when no compiler is available or
DGNN_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "coo_to_csr", "csr_to_csc_permute", "rmat_edges",
           "bin_fill"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graph_prep.cc")
_SO = os.path.join(_HERE, "libdgnn_graph.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("DGNN_NATIVE", "1") == "0":
            return None
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", _SO, _SRC],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_SO)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.dgnn_coo_to_csr.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p, i32p]
            lib.dgnn_csr_to_csc_permute.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i64p, i32p, i64p, i32p, i32p]
            lib.dgnn_rmat.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, i64p, i64p]
            lib.dgnn_bin_fill.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i64p, i64p, i32p, i64p,
                i32p, i32p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    e = src.shape[0]
    row_ptr = np.empty(num_nodes + 1, np.int64)
    col_ind = np.empty(e, np.int32)
    lib.dgnn_coo_to_csr(num_nodes, e, src, dst, row_ptr, col_ind)
    return row_ptr, col_ind


def csr_to_csc_permute(row_ptr: np.ndarray, col_ind: np.ndarray):
    lib = _load()
    assert lib is not None
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_ind = np.ascontiguousarray(col_ind, dtype=np.int32)
    n = row_ptr.shape[0] - 1
    e = col_ind.shape[0]
    col_ptr = np.empty(n + 1, np.int64)
    row_ind = np.empty(e, np.int32)
    permute = np.empty(e, np.int32)
    lib.dgnn_csr_to_csc_permute(n, e, row_ptr, col_ind, col_ptr, row_ind,
                                permute)
    return col_ptr, row_ind, permute


def bin_fill(starts: np.ndarray, counts: np.ndarray, width: int,
             col_ind: np.ndarray, edge_ids: np.ndarray):
    lib = _load()
    assert lib is not None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    col_ind = np.ascontiguousarray(col_ind, dtype=np.int32)
    edge_ids = np.ascontiguousarray(edge_ids, dtype=np.int64)
    s = starts.shape[0]
    nbr = np.empty((s, width), np.int32)
    edge = np.empty((s, width), np.int32)
    lib.dgnn_bin_fill(s, width, starts, counts, col_ind, edge_ids, nbr, edge)
    return nbr, edge


def rmat_edges(num_nodes: int, num_edges: int, seed: int = 0, a: float = 0.57,
               b: float = 0.19, c: float = 0.19):
    lib = _load()
    assert lib is not None
    src = np.empty(num_edges, np.int64)
    dst = np.empty(num_edges, np.int64)
    lib.dgnn_rmat(num_nodes, num_edges, seed, a, b, c, src, dst)
    return src, dst
