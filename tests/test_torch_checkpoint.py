"""The port's checkpoints (``repro_torch.train.checkpoint``): the cases of
``tests/test_substrate.py`` and ``tests/test_train_stack.py`` on the port
(torch trees and numpy trees), and checkpoints written by either package
restored into the other's tree of the same structure, array for array
(leaves flatten in sorted key order in both).  Restored values are equal
exactly."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves, tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer0": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                   "b": np.zeros((8,), np.float32)},
        "step_scale": np.float32(0.5),
    }


def _torch_tree(seed=0):
    """Params and an Adam state as the launcher saves them: keys out of
    sorted order, an int32 step, a stacked leaf."""
    rng = np.random.default_rng(seed)
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    p = {"embed": {"table": draw(6, 4)},
         "blocks": {"w": draw(2, 4, 4), "ln": {"scale": draw(2, 4)}}}
    opt = {"m": tree_map(lambda t: t * 0.1, p), "v": tree_map(lambda t: t.abs(), p),
           "step": torch.tensor(5, dtype=torch.int32)}
    return {"params": p, "opt": opt}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_module_is_documented():
    assert ckpt.__doc__


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))}}
    ckpt.save(str(tmp_path), 7, tree, extra={"loss": 1.5})
    assert ckpt.list_steps(str(tmp_path)) == [7]
    restored, extra = ckpt.restore(str(tmp_path), 7, tree)
    assert extra["loss"] == 1.5
    _assert_same(restored, tree)


def test_restore_latest_skips_incomplete(tmp_path):
    tree = {"a": torch.arange(4.0)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    bad = tmp_path / "step_00000003"  # a crash mid-write of step 3: no .complete
    bad.mkdir()
    (bad / "manifest.json").write_text("{broken")
    hit = ckpt.restore_latest(str(tmp_path), tree)
    assert hit is not None and hit[0] == 2


def test_checkpoint_prune(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in range(5):
        ckpt.save(str(tmp_path), s, tree)
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(AssertionError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(4)})


def test_checkpoint_leaf_count_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(AssertionError, match="1 arrays, model expects 2"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(3), "b": torch.zeros(1)})


def test_checkpoint_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    path = ckpt.save(d, 3, tree, extra={"lr": 0.1})
    assert os.path.exists(os.path.join(path, ".complete"))
    restored, extra = ckpt.restore(d, 3, jax.tree.map(np.zeros_like, tree))
    assert extra == {"lr": 0.1}
    _assert_same(restored, tree)


def test_checkpoint_restore_latest_skips_incomplete(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 1, _tree())
    ckpt.save(d, 2, _tree(seed=2))
    os.makedirs(os.path.join(d, "step_00000005"))  # no .complete
    assert ckpt.list_steps(d) == [1, 2]
    step, restored, _ = ckpt.restore_latest(d, jax.tree.map(np.zeros_like, _tree()))
    assert step == 2
    np.testing.assert_array_equal(restored["layer0"]["w"], _tree(seed=2)["layer0"]["w"])


def test_checkpoint_restore_latest_empty(tmp_path):
    assert ckpt.restore_latest(str(tmp_path / "none"), _tree()) is None


def test_checkpoint_prune_keeps_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _tree(seed=s))
    ckpt.prune(d, keep=2)
    assert ckpt.list_steps(d) == [4, 5]


def test_checkpoint_no_tmp_dirs_after_save(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 7, _tree())
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


def test_checkpoint_shape_mismatch_is_loud(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 1, _tree())
    wrong = _tree()
    wrong["layer0"]["w"] = np.zeros((2, 2), np.float32)
    with pytest.raises(AssertionError):
        ckpt.restore(d, 1, wrong)


def test_torch_tree_restores_dtypes_and_device(tmp_path):
    """A launcher tree (int32 step, float32 leaves) and a bf16 one come
    back with the like-tree's dtypes; bf16 round-trips exactly."""
    tree = _torch_tree()
    ckpt.save(str(tmp_path), 4, tree)
    restored, _ = ckpt.restore(str(tmp_path), 4, _zeros_like(tree))
    _assert_same(restored, tree)
    b16 = tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)
    ckpt.save(str(tmp_path), 5, b16)
    back, _ = ckpt.restore(str(tmp_path), 5, _zeros_like(b16))
    for x, y in zip(leaves(back), leaves(b16)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_port_checkpoint_restores_into_reference_tree(tmp_path):
    """Written by the port from torch tensors, read by the reference's
    ``restore`` into its jnp tree: the same arrays in the same places."""
    tree = _torch_tree(1)
    ckpt.save(str(tmp_path), 9, tree, extra={"arch": "x"})
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.asarray(t.numpy()).dtype),
                        tree_map(lambda t: t, tree))
    restored, extra = jckpt.restore(str(tmp_path), 9, like)
    assert extra == {"arch": "x"}
    assert jax.tree.structure(restored) == jax.tree.structure(like)
    got = restored["params"]["blocks"]["ln"]["scale"]
    np.testing.assert_array_equal(np.asarray(got), tree["params"]["blocks"]["ln"]["scale"].numpy())
    for x, y in zip(jax.tree.leaves(restored), leaves(tree)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert jckpt.list_steps(str(tmp_path)) == [9]


def test_reference_checkpoint_restores_into_port_tree(tmp_path):
    """Written by the reference from jnp arrays, read by the port's
    ``restore`` into a torch tree: the same arrays in the same places."""
    tree = _torch_tree(2)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree_map(lambda t: t, tree))
    jckpt.save(str(tmp_path), 11, jtree, extra={"loss": 2.0})
    assert ckpt.list_steps(str(tmp_path)) == [11]
    restored, extra = ckpt.restore(str(tmp_path), 11, _zeros_like(tree))
    assert extra == {"loss": 2.0}
    _assert_same(restored, tree)
    assert ckpt.restore_latest(str(tmp_path), _zeros_like(tree))[0] == 11
