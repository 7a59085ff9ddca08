"""Cache keys for tuned configs: graph-regime signature x machine fingerprint.

Port of ``src/repro/tune/signature.py``.  A tuned config is reusable
across graphs that *bucket the same way*, not across graphs that are
byte-identical, so the key quantizes the tile-nnz histogram instead of
hashing the edge list:

* tile nnz values collapse into power-of-two bins (``floor(log2(nnz))``),
  the same resolution at which :func:`core.scv.bucket_caps_for` picks caps;
* each bin's tile count collapses to ``round(log2(count + 1))`` — a
  half-octave count change is regime drift, a ±1-entry perturbation is not.

The signature half equals the reference's.  The machine half is
:meth:`simul.machine.MachineConfig.fingerprint` plus a tag for the torch
device (``torch-cuda-<card name>`` or ``torch-cpu``) where the reference
appends the jax backend (``-cpu``, ``-tpu``).  A config measured on one
card is never served on another, and a store written by the reference
never hands its config to the port: the composite key misses and the
tuner searches again.  That is the staleness rule.
"""
from __future__ import annotations

import hashlib
import math
import re

import numpy as np
import torch

from repro_torch.core.scv import DEFAULT_TILE
from repro_torch.device import resolve_device
from repro_torch.simul.machine import MachineConfig


def quantize_histogram(counts: np.ndarray, tile: int) -> tuple:
    """Quantized (log2-nnz-bin, log2-count-level) pairs, sorted.

    Stable under small perturbations: moving one edge between tiles — or
    adding/removing a tile — shifts a bin count by 1, which only changes
    ``round(log2(count + 1))`` near power-of-two boundaries, and even then
    by one level in one bin.
    """
    counts_arr = np.asarray(counts, dtype=np.int64)
    counts_arr = counts_arr[counts_arr > 0]
    if counts_arr.size == 0:
        return ()
    bins = np.floor(np.log2(counts_arr)).astype(np.int64)
    out = []
    for b in np.unique(bins):
        n = int((bins == b).sum())
        out.append((int(b), int(round(math.log2(n + 1)))))
    return tuple(out)


def histogram_signature(counts: np.ndarray, tile: int = DEFAULT_TILE) -> str:
    """Short stable id of a graph regime at reference tile ``tile``."""
    q = quantize_histogram(counts, tile)
    payload = f"T{int(tile)};" + ";".join(f"{b}:{lvl}" for b, lvl in q)
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def device_tag(device="cuda") -> str:
    """``torch-cpu``, or ``torch-cuda-<card name>`` with the name's
    non-alphanumerics folded to ``_``: never the reference's jax backend
    name, so the two never share a key."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"torch-{dev.type}"
    name = torch.cuda.get_device_name(dev)
    return "torch-cuda-" + re.sub(r"[^0-9A-Za-z]+", "_", name).strip("_")


def machine_fingerprint(machine: MachineConfig | None = None, device="cuda") -> str:
    """Machine half of the cache key: model constants + the torch device
    the config is measured and served on."""
    if machine is None:
        machine = MachineConfig()
    return f"{machine.fingerprint()}-{device_tag(device)}"


def cache_key(signature: str, fingerprint: str) -> str:
    return f"{signature}@{fingerprint}"
