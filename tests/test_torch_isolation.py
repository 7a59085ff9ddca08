"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports jax or the reference package, every module
imports with both blocked, and ``chip_smoke.py`` refuses to run without
a CUDA card."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    for root, dirs, files in os.walk(PORT):
        dirs.sort()  # one collection order in every test worker
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _module_name(path):
    rel = os.path.relpath(path, os.path.join(REPO, "src"))[: -len(".py")]
    parts = rel.split(os.sep)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_has_modules():
    names = {_module_name(p) for p in _port_files()}
    assert {"repro_torch.kernels.scv_spmm.scv_spmm", "repro_torch.kernels.scv_spmm.ops",
            "repro_torch.kernels.scv_spmm.ref", "repro_torch.kernels.scv_spmm.build",
            "repro_torch.models.gnn", "repro_torch.simul.datasets",
            "repro_torch.serve.graph_engine", "repro_torch.launch.graph_serve"} <= names


@pytest.mark.parametrize("path", [*_port_files(), os.path.join(REPO, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_jax_and_reference_blocked():
    modules = sorted(_module_name(p) for p in _port_files())
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_refuses(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
