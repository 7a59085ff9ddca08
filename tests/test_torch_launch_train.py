"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
the two training cases of ``tests/test_system.py`` at the reference's
sizes (the loss falls; 8 steps equal 4 steps, a checkpoint, a resume and 4
more, within the reference's 1e-5 relative), its flags and printed lines
against the reference launcher's, the production mesh on a one-device pool
(``--mesh prod`` gives ``--mesh none``'s losses bit for bit; several
distinct devices are refused), and no card."""
import re

import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as train_mod
from repro_torch.train import checkpoint as ckpt


def test_lm_training_loss_decreases(tmp_path):
    losses = train_mod.main(
        [
            "--arch", "gemma2-27b", "--reduced", "--steps", "12",
            "--batch", "4", "--seq", "32", "--lr", "3e-3",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "6", "--device", "cpu",
        ]
    )
    assert len(losses) == 12
    assert losses[-1] < losses[0]
    assert ckpt.list_steps(str(tmp_path)) == [6, 12]


def test_checkpoint_restart_determinism(tmp_path, capsys):
    """Run 8 steps; run 4 + restart + 4 — the same final loss."""
    args = ["--arch", "qwen1.5-32b", "--reduced", "--batch", "2", "--seq", "16",
            "--lr", "1e-3", "--total-steps", "8", "--device", "cpu"]
    full = train_mod.main(args + ["--steps", "8"])
    d1 = str(tmp_path / "a")
    train_mod.main(args + ["--steps", "4", "--ckpt-dir", d1, "--ckpt-every", "4"])
    capsys.readouterr()
    resumed = train_mod.main(
        args + ["--steps", "8", "--ckpt-dir", d1, "--ckpt-every", "100", "--resume"]
    )
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(resumed) == 4
    assert resumed[-1] == pytest.approx(full[-1], rel=1e-5)


def _options(main):
    with pytest.raises(SystemExit):
        main(["--help"])


def test_flags_and_printed_lines_match_reference(capsys):
    """The reference's flags plus ``--device``; the same printed lines with
    their numbers masked (the weights differ: each package draws its own
    from seed 0)."""
    _options(jtrain.main)
    want = set(re.findall(r"--[a-z-]+", capsys.readouterr().out))
    _options(train_mod.main)
    got = set(re.findall(r"--[a-z-]+", capsys.readouterr().out))
    assert got == want | {"--device"}

    args = ["--arch", "qwen1.5-32b", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "8", "--log-every", "2"]

    def mask(text):
        return [re.sub(r"[-+]?\d[\d.e+-]*", "N", line)
                for line in text.splitlines() if not line.startswith("[fault]")]

    jlosses = jtrain.main(args)
    want_lines = mask(capsys.readouterr().out)
    losses = train_mod.main(args + ["--device", "cpu"])
    assert mask(capsys.readouterr().out) == want_lines
    assert isinstance(losses, list) and len(losses) == len(jlosses) == 3
    assert all(isinstance(x, float) for x in losses)


@pytest.mark.parametrize("mesh", ["prod", "prod-multipod"])
def test_production_mesh_names_the_sharding_slice(mesh, monkeypatch, capsys):
    """The production mesh runs on a pool of one device, printing its
    ``[mesh]`` line, and is refused over several distinct devices, naming
    the ROADMAP item a multi-card step waits for."""
    args = ["--arch", "qwen1.5-32b", "--reduced", "--steps", "1", "--mesh", mesh,
            "--device", "cpu"]
    assert len(train_mod.main(args)) == 1
    dims = "2x16x16 ('pod', 'data', 'model')" if mesh == "prod-multipod" else \
        "16x16 ('data', 'model')"
    assert f"[mesh] {dims} over 1 distinct device(s) (cpu)" in capsys.readouterr().out
    monkeypatch.setattr(train_mod, "device_pool",
                        lambda device: (torch.device("cpu"), torch.device("meta")))
    with pytest.raises(NotImplementedError, match=r"2 distinct devices.*ROADMAP.md §1 item 6"):
        train_mod.main(args)


def test_production_mesh_losses_equal_no_mesh_bit_for_bit(capsys):
    args = ["--arch", "mamba2-780m", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--lr", "1e-3", "--device", "cpu"]
    none = train_mod.main(args)
    prod = train_mod.main(args + ["--mesh", "prod"])
    multi = train_mod.main(args + ["--mesh", "prod-multipod"])
    assert prod == none and multi == none  # floats: equal bits
    out = capsys.readouterr().out
    assert out.count("[mesh]") == 2 and "each of the 512 positions" in out


def test_production_mesh_places_every_leaf_by_its_sharding(capsys):
    """What ``--mesh prod`` places: params by ``make_param_sharding``, the
    moments by the params' shardings, the step replicated; the bytes the
    ``[mesh]`` line prints are the shard shapes'."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    spec = ARCHS["olmoe-1b-7b"]
    params, opt = train_mod.init_train_state(spec, True, "cpu")
    axes = spec.init(None, reduced=True, device="meta")[1]
    mesh = make_production_mesh(multi_pod=True, devices=("cpu",))
    p2, o2 = train_mod.place_on_mesh(mesh, params, opt, axes)
    assert all(a is b for a, b in zip(leaves((p2, o2)), leaves((params, opt))))
    pshard = shd.make_param_sharding(mesh, params, axes)
    want = shd.shard_bytes(params, pshard)
    assert want < sum(t.numel() * 4 for t in leaves(params))
    line = capsys.readouterr().out
    assert f"holds {want} B of params and {2 * want + 4} B of Adam state" in line


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "qwen1.5-32b", "--reduced", "--steps", "1"])
