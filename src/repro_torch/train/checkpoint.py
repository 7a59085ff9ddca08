"""Fault-tolerant checkpointing: atomic, versioned, resumable.

Port of ``src/repro/train/checkpoint.py``, with its layout (one directory
per step):

    <dir>/step_00000123/
        manifest.json   {step, n_arrays, treedef, shard, n_shards, extra}
        arrays.npz      flattened leaves (host copies)
        .complete       written last — a checkpoint without it is ignored

Writes go to ``step_X.tmp`` and are renamed at the end, so a crash
mid-write never corrupts the latest checkpoint; ``restore_latest`` walks
back over steps until it finds a complete one.

Leaves are flattened with dict keys in sorted order (``repro_torch.tree``),
as ``jax.tree.flatten`` flattens them, and ``restore`` reads only the
array count and shapes: a checkpoint written by either package restores
into the other's tree of the same structure, array for array.  The
manifest's ``treedef`` is the port's own structure string, not JAX's.
bfloat16 leaves are stored as float32 (numpy has no bfloat16; the value is
exact) and cast back to the tree's dtype on restore.  A leaf placed on a
mesh (``train.sharding.Sharded``) is gathered whole to the host, as the
reference's ``np.asarray`` gathers a sharded array, and restores whole on
the host, for the caller to place again.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.train.sharding import Sharded, gather
from repro_torch.tree import leaves, structure, unflatten


def _host(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = gather(x, "cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = leaves(tree)
    arrays = {f"a{i}": _host(x) for i, x in enumerate(flat)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_arrays": len(flat),
        "treedef": structure(tree),
        "shard": 0,
        "n_shards": 1,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, ".complete")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _like(arr: np.ndarray, ref):
    """``arr`` as ``ref``'s kind: a tensor of its dtype on its device (on
    the host for a placed leaf), or a numpy array of its dtype."""
    if isinstance(ref, Sharded):
        return torch.from_numpy(np.array(arr)).to(dtype=ref.dtype)
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device, dtype=ref.dtype)
    return arr.astype(ref.dtype) if hasattr(ref, "dtype") else arr


def restore(ckpt_dir: str, step: int, like_tree):
    """Restore into the structure of ``like_tree``; the leaf count and
    every shape must match (``AssertionError`` otherwise).  Returns
    ``(tree, extra)``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    refs = leaves(like_tree)
    if manifest["n_arrays"] != len(refs):
        raise AssertionError(
            f"checkpoint has {manifest['n_arrays']} arrays, model expects {len(refs)}"
        )
    out = []
    for i, ref in enumerate(refs):
        arr = data[f"a{i}"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise AssertionError((i, arr.shape, tuple(ref.shape)))
        out.append(_like(arr, ref))
    return unflatten(like_tree, out), manifest["extra"]


def restore_latest(ckpt_dir: str, like_tree):
    """Newest complete checkpoint as ``(step, tree, extra)``, or None.
    Skips partially written (crashed) checkpoints."""
    for step in reversed(list_steps(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, step, like_tree)
            return step, tree, extra
        except Exception:  # corrupt despite marker: keep walking back
            continue
    return None


def prune(ckpt_dir: str, keep: int = 3):
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
