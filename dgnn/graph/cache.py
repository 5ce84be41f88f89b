"""Disk cache for preprocessed graphs.

Host-side preprocessing (sorting + binning) is one-time per graph; caching
the finished `Graph` pytree as an .npz makes repeated benchmark/training
runs skip it entirely (reference analogue: none — dgNN re-runs scipy
preprocessing every script invocation, train_gatconv.py:78-94).
"""

from __future__ import annotations

import json
import os
import time

import jax.numpy as jnp
import numpy as np

from . import build
from .structure import BinnedAdj, CombineTable, Graph, build_graph_from_csr

__all__ = ["save_graph", "load_graph", "build_rmat_raw", "rmat_graph",
           "GRAPH_FORMAT"]

# Version of the binned layout in cached graph files; bump it whenever
# binning or the device layout changes, so a stale cache is never loaded.
GRAPH_FORMAT = "d7"


def _pack_binned(prefix: str, adj: BinnedAdj, store: dict, meta: dict):
    meta[prefix] = {"widths": list(adj.widths), "num_rows": adj.num_rows,
                    "num_edges": adj.num_edges}
    for i in range(adj.num_bins):
        store[f"{prefix}_nbr_{i}"] = np.asarray(adj.nbr[i])
        if adj.edge[i] is not None:
            store[f"{prefix}_edge_{i}"] = np.asarray(adj.edge[i])
        store[f"{prefix}_row_{i}"] = np.asarray(adj.row[i])
        store[f"{prefix}_count_{i}"] = np.asarray(adj.count[i])
    if adj.cmb is not None:
        store[f"{prefix}_cmb"] = np.asarray(adj.cmb.main)
        store[f"{prefix}_cmb_ov_rows"] = np.asarray(adj.cmb.ov_rows)
        store[f"{prefix}_cmb_ov"] = np.asarray(adj.cmb.ov)
    if adj.epos is not None:
        store[f"{prefix}_epos"] = np.asarray(adj.epos)


def _unpack_binned(prefix: str, z, meta: dict) -> BinnedAdj:
    m = meta[prefix]
    nbins = len(m["widths"])
    return BinnedAdj(
        nbr=tuple(jnp.asarray(z[f"{prefix}_nbr_{i}"]) for i in range(nbins)),
        edge=tuple(jnp.asarray(z[f"{prefix}_edge_{i}"])
                   if f"{prefix}_edge_{i}" in z.files else None
                   for i in range(nbins)),
        row=tuple(jnp.asarray(z[f"{prefix}_row_{i}"]) for i in range(nbins)),
        count=tuple(jnp.asarray(z[f"{prefix}_count_{i}"]) for i in range(nbins)),
        cmb=(CombineTable(main=jnp.asarray(z[f"{prefix}_cmb"]),
                          ov_rows=jnp.asarray(z[f"{prefix}_cmb_ov_rows"]),
                          ov=jnp.asarray(z[f"{prefix}_cmb_ov"]))
             if f"{prefix}_cmb" in z.files else None),
        epos=(jnp.asarray(z[f"{prefix}_epos"])
              if f"{prefix}_epos" in z.files else None),
        widths=tuple(m["widths"]),
        num_rows=m["num_rows"],
        num_edges=m["num_edges"],
    )


def save_graph(path: str, g: Graph) -> None:
    store = {}
    meta = {"num_nodes": g.num_nodes, "num_edges": g.num_edges}
    _pack_binned("fwd", g.fwd, store, meta)
    _pack_binned("bwd", g.bwd, store, meta)
    store["row_ptr"] = np.asarray(g.row_ptr)
    store["col_ind"] = np.asarray(g.col_ind)
    store["col_ptr"] = np.asarray(g.col_ptr)
    store["row_ind"] = np.asarray(g.row_ind)
    store["permute"] = np.asarray(g.permute)
    store["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    # atomic write: interrupted runs must not leave a corrupt cache
    tmp = path + ".tmp.npz"
    np.savez(tmp, **store)
    import os

    os.replace(tmp, path)


def load_graph(path: str) -> Graph:
    z = np.load(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    return Graph(
        row_ptr=jnp.asarray(z["row_ptr"]),
        col_ind=jnp.asarray(z["col_ind"]),
        col_ptr=jnp.asarray(z["col_ptr"]),
        row_ind=jnp.asarray(z["row_ind"]),
        permute=jnp.asarray(z["permute"]),
        fwd=_unpack_binned("fwd", z, meta),
        bwd=_unpack_binned("bwd", z, meta),
        num_nodes=meta["num_nodes"],
        num_edges=meta["num_edges"],
    )


def build_rmat_raw(n: int, e: int, out_path: str, seed: int = 0,
                   log=print) -> None:
    """Generate the R-MAT graph and write its raw CSR/CSC/permute arrays.

    The raw arrays do not depend on the binned layout, so a layout change
    (GRAPH_FORMAT bump) re-pays only binning, not generation and sorts."""
    from ..data.synthetic import rmat_edges

    t0 = time.time()
    src, dst = rmat_edges(n, e, seed=seed)
    src, dst = build.remove_self_loops(src, dst)
    src, dst = build.add_self_loops(src, dst, n)
    row_ptr, col_ind = build.coo_to_csr(src, dst, n)
    del src, dst
    col_ptr, row_ind, permute = build.csr_to_csc_permute(row_ptr, col_ind)
    log(f"rmat raw arrays {time.time() - t0:.0f}s")
    meta = dict(num_nodes=n, num_edges=int(col_ind.shape[0]), seed=seed)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp.npz"
    np.savez(tmp, row_ptr=row_ptr.astype(np.int64),
             col_ind=col_ind.astype(np.int32),
             col_ptr=col_ptr.astype(np.int64),
             row_ind=row_ind.astype(np.int32),
             permute=permute.astype(np.int32),
             meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    os.replace(tmp, out_path)


def rmat_graph(n: int, e: int, cache_dir: str, seed: int = 0, log=print):
    """The R-MAT graph at (n, e) through the two-level disk cache.

    Returns (graph, raw) where ``raw`` is the loaded raw-array npz (for
    tasks derived from the graph's own edges).  Missing cache files are
    built, never skipped."""
    raw_path = os.path.join(cache_dir, f"rmat_raw_{n}_{e}.npz")
    path = os.path.join(cache_dir, f"rmat_graph_{n}_{e}_{GRAPH_FORMAT}.npz")
    if not os.path.exists(raw_path):
        build_rmat_raw(n, e, raw_path, seed=seed, log=log)
    raw = np.load(raw_path)
    if os.path.exists(path):
        return load_graph(path), raw
    t0 = time.time()
    g = build_graph_from_csr(raw["row_ptr"], raw["col_ind"], raw["col_ptr"],
                             raw["row_ind"], raw["permute"],
                             edge_tables=False)
    log(f"binned graph {time.time() - t0:.0f}s")
    save_graph(path, g)
    return g, raw
