"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
the two training cases of ``tests/test_system.py`` at the reference's
sizes (the loss falls; 8 steps equal 4 steps, a checkpoint, a resume and 4
more, within the reference's 1e-5 relative), its flags and printed lines
against the reference launcher's, the production mesh on a one-device pool
(on a data-only mesh ``--mesh prod`` gives ``--mesh none``'s losses bit for
bit; on 16x16 each group splits its products over 16 "model" positions and
gives the (1, 16) mesh's bits, ``--mesh none``'s within 1e-5; several
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
    ``[mesh]`` line; over a pool of several distinct devices (the CPU and
    ``meta``) it is no longer refused: each position's shards sit on its
    device, and the line names both devices and what each holds."""
    args = ["--arch", "qwen1.5-32b", "--reduced", "--steps", "1", "--mesh", mesh,
            "--device", "cpu"]
    assert len(train_mod.main(args)) == 1
    dims = "2x16x16 ('pod', 'data', 'model')" if mesh == "prod-multipod" else \
        "16x16 ('data', 'model')"
    assert f"[mesh] {dims} over 1 distinct device(s) (cpu)" in capsys.readouterr().out
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    monkeypatch.setattr(train_mod, "device_pool",
                        lambda device: (torch.device("cpu"), torch.device("meta")))
    spec = ARCHS["qwen1.5-32b"]
    params, opt = train_mod.init_train_state(spec, True, "cpu")
    axes = spec.init(None, reduced=True, device="meta")[1]
    pool = train_mod.device_pool("cpu")
    placed = train_mod.place_on_mesh(make_production_mesh(multi_pod=mesh == "prod-multipod",
                                                          devices=pool), params, opt, axes)
    line = capsys.readouterr().out
    assert f"[mesh] {dims} over 2 distinct device(s) (cpu, meta)" in line
    assert "cpu holds" in line and "meta holds" in line
    for x in leaves(placed):
        for pos in shd.positions(x.sharding.mesh):
            assert x.shards[pos].device == x.sharding.mesh.devices[pos]
            assert tuple(x.shards[pos].shape) == x.sharding.shard_shape(x.shape)


#: How far the 16-way split of the reduced Mamba2's products (its
#: vocabulary) may put a loss from ``--mesh none``'s, relative, on the CPU.
SPLIT_TOL = 1e-5


def _meshes(monkeypatch, model):
    """``--mesh prod``/``prod-multipod`` laid out data-only as 256/512
    positions (``model`` 1), or as one data row of ``model`` positions a
    pod (``(1, model)``, ``(2, 1, model)``), in place of 16x16."""
    from repro_torch.launch.mesh import make_mesh

    def make(multi_pod=False, devices=None):
        pods = 2 if multi_pod else 1
        n = 256 * pods if model == 1 else model * pods
        return make_mesh(n, model_parallel=model, n_pods=pods, devices=devices)

    monkeypatch.setattr(train_mod, "make_production_mesh", make)


def _close(got, want, tol=SPLIT_TOL):
    return len(got) == len(want) and all(abs(a - b) <= tol * abs(b) for a, b in zip(got, want))


def test_production_mesh_losses_equal_no_mesh_bit_for_bit(capsys, monkeypatch):
    """``--batch 2`` is one data group (16 does not divide 2).  On a
    data-only mesh of ``--mesh prod``'s 256 positions (256x1):
    ``--mesh none``'s losses bit for bit, over real shards; on 2x256x1 at
    ``--batch 1``, one group again, bit for bit.  On the 16x16 mesh the
    group splits its products over the 16 "model" positions (here the
    vocabulary: the reduced arch's 8 mamba heads do not divide 16): the
    losses of the same run on a (1, 16) mesh bit for bit, ``--mesh none``'s
    within ``SPLIT_TOL``; on 2x16x16 the same batch splits over the 2-way
    pod axis into two groups, whose mean loss rounds otherwise: within
    ``SPLIT_TOL`` too."""
    args = ["--arch", "mamba2-780m", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--lr", "1e-3", "--device", "cpu"]
    one = args[:6] + ["1"] + args[7:]
    none, none_one = train_mod.main(args), train_mod.main(one)
    prod = train_mod.main(args + ["--mesh", "prod"])
    multi = train_mod.main(args + ["--mesh", "prod-multipod"])
    out = capsys.readouterr().out
    assert out.count("[mesh]") == 2 and "each of the 512 positions" in out
    assert "model axis 16: mamba heads whole (8 on 16), vocab rows 32 a position" in out
    assert _close(prod, none) and _close(multi, none)
    with monkeypatch.context() as mp:
        _meshes(mp, 16)
        assert train_mod.main(args + ["--mesh", "prod"]) == prod
    with monkeypatch.context() as mp:
        _meshes(mp, 1)
        assert train_mod.main(args + ["--mesh", "prod"]) == none  # floats: equal bits
        assert train_mod.main(one + ["--mesh", "prod-multipod"]) == none_one
    out = capsys.readouterr().out
    assert out.count("[mesh]") == 3 and "each of the 512 positions" in out


def test_production_mesh_places_every_leaf_by_its_sharding(capsys):
    """What ``--mesh prod`` places: params by ``make_param_sharding``, the
    moments by the params' shardings, the step replicated, each position's
    block a tensor of its own; the ``[mesh]`` line prints the shard
    shapes' bytes and ``held_bytes``, equal at every position."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    spec = ARCHS["olmoe-1b-7b"]
    params, opt = train_mod.init_train_state(spec, True, "cpu")
    axes = spec.init(None, reduced=True, device="meta")[1]
    mesh = make_production_mesh(multi_pod=True, devices=("cpu",))
    p2, o2 = train_mod.place_on_mesh(mesh, params, opt, axes)
    pshard = shd.make_param_sharding(mesh, params, axes)
    for x, w, sh in zip(leaves(p2), leaves(params), leaves(pshard)):
        assert x.sharding.spec == sh.spec
        assert torch.equal(shd.gather(x, "cpu"), w)
    assert all(x.sharding.spec == () for x in [o2["step"]])
    want = shd.shard_bytes(params, pshard)
    assert want < sum(t.numel() * 4 for t in leaves(params))
    line = capsys.readouterr().out
    assert f"holds {want} B of params and {2 * want + 4} B of Adam state (shard shapes)" in line
    assert f"held_bytes: 512 position(s) {want} B of params and {2 * want + 4} B" in line


def test_production_mesh_sixteen_groups_resume(tmp_path, capsys, monkeypatch):
    """``--mesh prod --batch 16``: 16 data groups of one sequence.  A run
    stopped after 2 of 4 steps and resumed (its checkpoint gathered whole,
    then placed again) gives the unbroken run's losses bit for bit: the
    checkpoint keeps float32 exactly and the step is deterministic here.
    So on a data-only 16x1 mesh, whose unbroken run is within 1e-5
    relative of ``--mesh none``, and on the 16x16 mesh, whose groups split
    their products over "model": its unbroken run gives the bits of the
    same step on a (1, 16) mesh with 16 microbatches (the same slices in
    the same order), and is within ``SPLIT_TOL`` of ``--mesh none``."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import sharding as shd
    from repro_torch.train.fault import DataSkipper

    args = ["--arch", "mamba2-780m", "--reduced", "--batch", "16", "--seq", "8", "--lr",
            "1e-3", "--device", "cpu", "--total-steps", "4"]
    none = train_mod.main(args + ["--steps", "4"])
    args += ["--mesh", "prod"]

    def resumed(path):
        whole = train_mod.main(args + ["--steps", "4"])
        ck = ["--ckpt-dir", str(path), "--ckpt-every", "2"]
        first = train_mod.main(args + ["--steps", "2"] + ck)
        rest = train_mod.main(args + ["--steps", "4", "--resume"] + ck)
        assert "resumed from step 2" in capsys.readouterr().out
        assert first + rest == whole
        return whole

    with monkeypatch.context() as mp:
        mp.setattr(train_mod, "make_production_mesh",
                   lambda multi_pod=False, devices=None: make_mesh(16, model_parallel=1,
                                                                   devices=devices))
        data_only = resumed(tmp_path / "data")
    assert len(data_only) == len(none) == 4 and _close(data_only, none), (data_only, none)
    split = resumed(tmp_path / "split")
    assert _close(split, none), (split, none)

    spec = ARCHS["mamba2-780m"]
    mesh = make_mesh(16, model_parallel=16, devices=("cpu",))
    params, opt = train_mod.init_train_state(spec, True, "cpu")
    axes = spec.init(None, reduced=True, device="meta")[1]
    params, opt = train_mod.place_on_mesh(mesh, params, opt, axes)
    step = spec.make_train_step(AdamConfig(lr=1e-3, total_steps=4, warmup_steps=1),
                                reduced=True, microbatch=16)
    batch_fn = train_mod.make_batch_fn(spec, spec.cfg(True), 16, 8, "cpu")
    skipper, row = DataSkipper(seed=0), []
    with shd.use_mesh(mesh):
        for _ in range(4):
            params, opt, m = step(params, opt, batch_fn(skipper.next_batch_id()))
            row.append(float(m["loss"]))
    assert row == split


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "qwen1.5-32b", "--reduced", "--steps", "1"])
