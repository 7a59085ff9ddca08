"""The port's int8 gradient compression (``repro_torch.optim.compress``)
against the reference's ``src/repro/optim/compress.py``, bit for bit on
seeded numpy inputs: ``quantize``, ``dequantize``, ``ef_state`` and
``compress_with_feedback`` eagerly; ``compressed_psum`` over one member
against the reference's ``shard_map`` over a one-device "pod" mesh in
process, and over four members against ``shard_map`` over four forced host
devices (this file run as a script in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  Then the
reference's claim (``tests/test_substrate.py``): over 30 steps of error
feedback the accumulated compressed mean stays within one quantization
step of the true mean."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

MEMBERS = 4
STEPS = 30


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((33, 7)) * scale).astype(np.float32),
            "blk": {"b": (rng.standard_normal(100) * 1e-3 * scale).astype(np.float32),
                    "z": np.zeros((5, 3), np.float32)}}


def _members(seed):
    rng = np.random.default_rng(seed)
    grads = [_tree(rng) for _ in range(MEMBERS)]
    errors = [_tree(rng, 0.01) for _ in range(MEMBERS)]
    return grads, errors


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def _bits_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), (k, np.abs(got[k].astype(np.float64)
                                                              - want[k]).max())


def _shard_map():
    try:
        from jax import shard_map
    except ImportError:  # older jax keeps it under experimental
        from jax.experimental.shard_map import shard_map
    return shard_map


def test_quantize_dequantize_and_feedback_bit_for_bit():
    import jax.numpy as jnp

    from repro.optim import compress as J
    from repro_torch.optim import compress as T

    rng = np.random.default_rng(0)
    for x in [rng.standard_normal(1000).astype(np.float32),
              (rng.standard_normal((17, 9)) * 1e-6).astype(np.float32),
              np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32),  # halves: to even
              np.zeros(8, np.float32)]:
        jq, js = J.quantize(jnp.asarray(x))
        tq, ts = T.quantize(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert T.dequantize(tq, ts).numpy().tobytes() == \
            np.asarray(J.dequantize(jq, js)).tobytes()
    grads, errors = _members(1)
    jq, js, je = J.compress_with_feedback(grads[0], errors[0])
    tq, ts, te = T.compress_with_feedback(_to_torch(grads[0]), _to_torch(errors[0]))
    for got, want in [(tq, jq), (ts, js), (te, je)]:
        _bits_equal(got, want)
    _bits_equal(T.ef_state(_to_torch(grads[0])), J.ef_state(grads[0]))


def test_compressed_psum_one_member_bit_for_bit():
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.optim import compress as J
    from repro_torch.optim import compress as T

    grads, errors = _members(2)
    mesh = jax.make_mesh((1,), ("pod",))
    fn = _shard_map()(lambda g, e: J.compressed_psum(g, e, "pod"), mesh=mesh,
                      in_specs=(P(), P()), out_specs=(P(), P()))
    jmean, jerr = fn(grads[0], errors[0])
    tmean, terr = T.compressed_psum([_to_torch(grads[0])], [_to_torch(errors[0])], "pod")
    _bits_equal(tmean, jmean)
    _bits_equal(terr[0], jerr)


def _reference_four_members(path):
    """Run in the subprocess: the reference's ``compressed_psum`` in
    ``shard_map`` over four host devices, the members stacked on a leading
    axis split over "pod"; every member's mean and residual saved."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.optim import compress as J

    assert len(jax.devices()) == MEMBERS
    grads, errors = _members(3)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    mesh = jax.make_mesh((MEMBERS,), ("pod",))

    def body(g, e):
        g, e = jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e)
        mean, err = J.compressed_psum(g, e, "pod")
        return jax.tree.map(lambda x: x[None], mean), jax.tree.map(lambda x: x[None], err)

    fn = _shard_map()(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                      out_specs=(P("pod"), P("pod")))
    mean, err = fn(stack(grads), stack(errors))
    out = {f"mean/{k}": v for k, v in _flat(jax.tree.map(np.asarray, mean))}
    out.update({f"err/{k}": v for k, v in _flat(jax.tree.map(np.asarray, err))})
    np.savez(path, **out)


def test_compressed_psum_four_members_bit_for_bit(tmp_path):
    from repro_torch.optim import compress as T

    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = np.load(path)
    grads, errors = _members(3)
    mean, errs = T.compressed_psum([_to_torch(g) for g in grads],
                                   [_to_torch(e) for e in errors], "pod")
    for k, v in _flat(mean):
        for i in range(MEMBERS):  # every member holds the same mean
            assert v.tobytes() == ref[f"mean/{k}"][i].tobytes(), (k, i)
    for i, e in enumerate(errs):
        for k, v in _flat(e):
            assert v.tobytes() == ref[f"err/{k}"][i].tobytes(), (k, i)


def test_compressed_psum_checks_members_and_the_mesh_axis():
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compress as T
    from repro_torch.train import sharding as shd

    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="error trees"):
        T.compressed_psum([g, g], [g], "pod")
    mesh = make_mesh(64, n_pods=2, devices=(torch.device("cpu"),))
    with shd.use_mesh(mesh):
        T.compressed_psum([g, g], [g, g], "pod")
        with pytest.raises(ValueError, match="axis"):
            T.compressed_psum([g, g, g], [g, g, g], "pod")
        with pytest.raises(ValueError, match="axis"):
            T.compressed_psum([g, g], [g, g], "rows")


def test_error_feedback_keeps_the_accumulated_mean_within_one_step():
    """The reference's claim (``tests/test_substrate.py``) over four
    members: after 30 steps the accumulated compressed mean differs from
    the accumulated true mean by at most one quantization step (the last
    call's shared scale; the difference is the members' mean residual, each
    entry at most half a step), not 30 of them."""
    from repro_torch.optim import compress as T

    rng = np.random.default_rng(1)
    n = 64
    errors = [T.ef_state({"w": torch.zeros(n)}) for _ in range(MEMBERS)]
    total_true = np.zeros(n)
    total_comp = np.zeros(n)
    for _ in range(STEPS):
        grads = [{"w": torch.from_numpy(rng.standard_normal(n).astype(np.float32))}
                 for _ in range(MEMBERS)]
        scale = max(float((g["w"] + e["w"]).abs().max()) for g, e in zip(grads, errors)) / 127
        mean, errors = T.compressed_psum(grads, errors, "pod")
        total_true += np.mean([g["w"].numpy().astype(np.float64) for g in grads], axis=0)
        total_comp += mean["w"].numpy()
    resid = np.abs(total_true - total_comp).max()
    assert resid <= scale, (resid, scale)
    assert resid < 0.1, resid  # the reference's own bound


if __name__ == "__main__":
    _reference_four_members(sys.argv[1])
