"""Dataset loaders: real data from disk when available, synthetic fallback.

Real formats supported:
- citation graphs: an ``.npz`` with arrays {src, dst, features, labels,
  train_mask, val_mask, test_mask} (planetoid-style), searched under
  ``$DGNN_DATA`` or ``~/.dgnn/data``.
- ModelNet40: the reference's ``modelnet40-sampled-2048.h5`` layout
  (train/data, train/label, test/data, test/label; train_edgeconv.py:85-136)
  if h5py is importable, else synthetic point clouds.
"""

from __future__ import annotations

import os

import numpy as np

from . import synthetic

__all__ = ["load_citation_dataset", "load_node_task", "load_modelnet",
           "data_dir"]


def data_dir() -> str:
    return os.environ.get("DGNN_DATA",
                          os.path.expanduser("~/.dgnn/data"))


def load_citation_dataset(name: str, seed: int = 0) -> synthetic.CitationData:
    path = os.path.join(data_dir(), f"{name}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return synthetic.CitationData(
            src=z["src"], dst=z["dst"], num_nodes=int(z["features"].shape[0]),
            features=z["features"].astype(np.float32),
            labels=z["labels"].astype(np.int32),
            train_mask=z["train_mask"], val_mask=z["val_mask"],
            test_mask=z["test_mask"],
            n_classes=int(z["labels"].max()) + 1,
        )
    return synthetic.synthetic_citation(name, seed=seed)


def load_node_task(name: str, seed: int = 0, cache_dir: str | None = None):
    """Node-classification task for the training CLIs:
    (graph, features, labels, train_mask, test_mask, n_classes), arrays on
    device.

    Reddit is the R-MAT graph at Reddit's exact scale through the disk cache
    in ``cache_dir`` (graph/cache.rmat_graph, built on first use) with
    labels and features derived FROM ITS OWN EDGES (BFS-Voronoi regions), so
    the accuracy column is meaningful."""
    import jax.numpy as jnp

    from ..graph.structure import build_graph

    if name == "reddit":
        from ..graph.cache import rmat_graph

        n, e, f, c = synthetic.CITATION_SHAPES["reddit"]
        if cache_dir is None:
            raise ValueError("the reddit task needs a cache_dir")
        graph, raw = rmat_graph(n, e, cache_dir, seed=seed)
        feats, lab, tr, _va, te = synthetic.structure_task_from_csr(
            raw["row_ptr"], raw["col_ind"], c, f, seed=seed)
    else:
        data = load_citation_dataset(name, seed=seed)
        graph = build_graph(data.src, data.dst, data.num_nodes)
        feats, lab, tr, te = (data.features, data.labels, data.train_mask,
                              data.test_mask)
        c = data.n_classes
    return (graph, jnp.asarray(feats), jnp.asarray(lab), jnp.asarray(tr),
            jnp.asarray(te), c)


def load_modelnet(num_points: int = 1024, path: str | None = None,
                  train_samples: int = 512, test_samples: int = 128,
                  seed: int = 0):
    """Returns (x_train, y_train, x_test, y_test)."""
    path = path or os.path.join(data_dir(), "modelnet40-sampled-2048.h5")
    if os.path.exists(path):
        try:
            import h5py  # optional dep, gated

            with h5py.File(path, "r") as f:
                xtr = f["train/data"][:, :num_points].astype(np.float32)
                ytr = f["train/label"][:].squeeze().astype(np.int32)
                xte = f["test/data"][:, :num_points].astype(np.float32)
                yte = f["test/label"][:].squeeze().astype(np.int32)
            return xtr, ytr, xte, yte
        except ImportError:
            pass
    # shared class templates, disjoint instance seeds (train/test must
    # describe the SAME classes for test accuracy to be meaningful)
    xtr, ytr = synthetic.synthetic_point_clouds(train_samples, num_points,
                                                seed=seed, template_seed=seed)
    xte, yte = synthetic.synthetic_point_clouds(test_samples, num_points,
                                                seed=seed + 1,
                                                template_seed=seed)
    return xtr, ytr, xte, yte
