"""The port's production meshes (``repro_torch.launch.mesh``) over a pool
of ``cpu`` devices: the reference's shapes and axis names (its functions
with ``jax.make_mesh`` recording what it was asked for, and
``train/fault.py``'s elastic shapes), the pool laid over the positions in order,
an import that touches no device, and a default pool that raises without
a card."""
import os
import subprocess
import sys

import pytest
import torch

from repro.train.fault import elastic_mesh_shapes
from repro_torch.launch import mesh as M

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def reference_mesh(monkeypatch):
    """The reference's mesh functions with ``jax.make_mesh`` recording
    ``(shape, axis names)`` instead of asking for that many devices."""
    from repro.launch import mesh as jmesh

    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    return jmesh


def test_production_meshes(reference_mesh):
    m = M.make_production_mesh(devices=(CPU,) * 256)
    assert (m.devices.shape, m.axis_names) == reference_mesh.make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16}
    assert m.axis_names == ("data", "model") and m.size == 256
    mp = M.make_production_mesh(multi_pod=True, devices=(CPU,) * 512)
    assert list(mp.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert mp.devices.shape == (2, 16, 16)
    assert (mp.devices.shape, mp.axis_names) == \
        reference_mesh.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("n_chips,mp,pods", [(256, 16, 1), (240, 16, 1), (512, 16, 1),
                                             (16, 16, 1), (8, 16, 1), (192, 16, 1),
                                             (512, 16, 2), (480, 16, 2), (64, 8, 1)])
def test_elastic_mesh_matches_the_reference(reference_mesh, n_chips, mp, pods):
    shape, axes = reference_mesh.make_mesh(n_chips, model_parallel=mp, n_pods=pods)
    m = M.make_mesh(n_chips, model_parallel=mp, n_pods=pods, devices=(CPU,))
    assert m.devices.shape == shape and m.axis_names == axes
    assert tuple(m.shape) == axes and tuple(m.shape.values()) == shape
    if pods == 1:
        assert shape == elastic_mesh_shapes(n_chips, mp)


def test_pool_is_laid_over_the_positions_in_order():
    pool = (CPU, torch.device("meta"), CPU)
    m = M.make_production_mesh(devices=pool)
    flat = list(m.devices.flat)
    assert flat[:6] == [CPU, torch.device("meta"), CPU] * 2
    assert m.distinct_devices == (CPU, torch.device("meta"))
    assert M.make_production_mesh(devices=(CPU,) * 256).distinct_devices == (CPU,)
    assert M.device_pool("cpu") == (CPU,)
    with pytest.raises(ValueError, match="empty"):
        M.make_production_mesh(devices=())


def test_import_touches_no_device():
    code = (
        "import torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a device was touched at import')\n"
        "torch.cuda.is_available = torch.cuda.device_count = refuse\n"
        "torch.cuda.current_device = torch.cuda.init = refuse\n"
        "import repro_torch.launch.mesh as m\n"
        "import repro_torch.train.sharding as s\n"
        "assert not any(isinstance(v, s.Mesh) for v in vars(m).values())\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stdout + proc.stderr


def test_default_pool_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default pool resolves to it")
    with pytest.raises(RuntimeError, match="none is"):
        M.make_production_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh(16, devices=("cuda",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.device_pool("cuda")
