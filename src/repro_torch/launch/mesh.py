"""Production meshes.  Port of ``src/repro/launch/mesh.py``.

FUNCTIONS, not module constants: importing this module touches no device,
and elastic re-meshing (``train/fault.py``) rebuilds meshes with other
chip counts at run time.  A mesh is laid over a device pool, position by
position in order, repeating the pool when it is shorter than the mesh (as
``core/exec.py``'s pool may name one card more than once): by default every
CUDA card (``core.exec.cuda_pool``, which raises without one); tests pass
``devices=(torch.device("cpu"),) * n``.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.exec import cuda_pool, pool_device
from repro_torch.device import resolve_device
from repro_torch.train.sharding import Mesh


def device_pool(device) -> tuple:
    """The pool an entry point's ``--device`` names: every card for
    ``cuda`` (no index; raises without one), else that one device."""
    dev = resolve_device(device)
    return cuda_pool() if dev.type == "cuda" and dev.index is None else (dev,)


def _mesh(shape, axes, devices) -> Mesh:
    pool = [pool_device(d) for d in devices] if devices is not None else list(cuda_pool())
    if not pool:
        raise ValueError("an empty device pool")
    n = math.prod(shape)
    grid = np.empty(n, dtype=object)
    grid[:] = [pool[i % len(pool)] for i in range(n)]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 chips/pod ("data","model"); multi_pod adds a leading
    2-pod axis (512 chips) that carries only DP gradient traffic."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices)


def make_mesh(n_chips: int, model_parallel: int = 16, n_pods: int = 1, devices=None) -> Mesh:
    """Elastic variant: largest mesh over surviving chips (fault.py)."""
    per_pod = n_chips // n_pods
    data = max(1, per_pod // model_parallel)
    if n_pods > 1:
        return _mesh((n_pods, data, model_parallel), ("pod", "data", "model"), devices)
    return _mesh((data, model_parallel), ("data", "model"), devices)
