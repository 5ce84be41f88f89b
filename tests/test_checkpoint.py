"""Checkpoint/resume round-trip through one .npz of the flattened pytree."""

import jax.numpy as jnp
import numpy as np
import pytest

from dgnn.utils import load_checkpoint, save_checkpoint


def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)},
             "step": jnp.int32(7)}
    path = str(tmp_path / "ckpt" / "state.npz")
    save_checkpoint(path, 1, state)
    state2 = {"params": {"w": state["params"]["w"] * 2}, "step": jnp.int32(8)}
    save_checkpoint(path, 2, state2)

    template = {"params": {"w": jnp.zeros((2, 3), jnp.float32)},
                "step": jnp.int32(0)}
    step, restored = load_checkpoint(path, template)
    assert step == 2
    np.testing.assert_allclose(restored["params"]["w"],
                               np.asarray(state2["params"]["w"]))
    assert int(restored["step"]) == 8


def test_restore_empty_returns_none(tmp_path):
    assert load_checkpoint(str(tmp_path / "empty.npz"),
                           {"x": jnp.zeros(1)}) is None


def test_restore_rejects_mismatched_template(tmp_path):
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, 3, {"a": jnp.zeros((2, 2)), "b": jnp.ones(3)})
    with pytest.raises(ValueError, match="template expects"):
        load_checkpoint(path, {"a": jnp.zeros((2, 2))})
    with pytest.raises(ValueError, match="vs template"):
        load_checkpoint(path, {"a": jnp.zeros((2, 3)), "b": jnp.ones(3)})
