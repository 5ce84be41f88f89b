"""Checkpoint/resume as one ``.npz`` of a flattened pytree.

The reference has only a vestigial --save/--load-model-path pair (save never
called, train_edgeconv.py:246-247; SURVEY.md §5).  Here: the full train
state (params, optimizer state, batch statistics) and its step go into one
file, written atomically, and restore checks every leaf against a template
of the same structure.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

_STEP = "__step__"


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}


def save_checkpoint(path: str, step: int, state: Any) -> None:
    """Write ``state`` and ``step`` to ``path`` (atomic replace)."""
    store = _flat(state)
    store[_STEP] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **store)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: Any) -> Optional[tuple]:
    """Returns (step, state) or None if ``path`` does not exist.

    ``template`` is a pytree of the saved structure; a missing or extra
    leaf, or one whose shape or dtype differs, raises ValueError."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    step = int(stored.pop(_STEP))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    names = [jax.tree_util.keystr(k) for k, _ in leaves]
    if sorted(names) != sorted(stored):
        raise ValueError(f"checkpoint {path} holds {sorted(stored)}, "
                         f"template expects {sorted(names)}")
    out = []
    for name, (_, ref) in zip(names, leaves):
        v = stored[name]
        if v.shape != np.shape(ref) or v.dtype != np.asarray(ref).dtype:
            raise ValueError(f"checkpoint leaf {name}: {v.shape} {v.dtype} "
                             f"vs template {np.shape(ref)} "
                             f"{np.asarray(ref).dtype}")
        out.append(v)
    return step, jax.tree_util.tree_unflatten(treedef, out)
