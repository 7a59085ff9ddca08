"""The port's copy of the HLO cost parser (``repro_torch.launch.hlocost``)
and of ``launch/dryrun.py::collective_bytes`` against the reference's.
The HLO of each function of ``tests/test_hlocost.py`` is compiled by JAX
here and goes through both analyzers: the ``CostTotals`` are equal field
for field (and hold the reference test's FLOP counts).  Hand-written HLO
with collectives (async pairs, tuples, a ``while`` with a known trip
count) goes through both ``collective_bytes`` and both analyzers."""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import pytest

from repro.launch import hlocost as J
from repro_torch.launch import dryrun as TD
from repro_torch.launch import hlocost as T


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` (512 host
    devices) when imported: the backend is started first, so the flag
    reaches nothing here, and the variable is put back for later tests."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _compile(f, *specs):
    return jax.jit(f).lower(*specs).compile().as_text()


def _scan(x, ws):
    def body(x, w):
        return jnp.tanh(x @ w), None
    x, _ = jax.lax.scan(body, x, ws)
    return x


def _nested(x, ws):
    def outer(x, w2):
        def inner(x, w):
            return x @ w, None
        x, _ = jax.lax.scan(inner, x, w2)
        return x, None
    x, _ = jax.lax.scan(outer, x, ws)
    return x


def _batched(a, b):
    return jnp.einsum("bij,bjk->bik", a, b)


S = jax.ShapeDtypeStruct
CASES = {
    **{f"scan{n}": (_scan, (S((128, 128), jnp.float32), S((n, 128, 128), jnp.float32)),
                    2 * 128**3 * n) for n in (1, 2, 4, 8, 9)},
    "nested": (_nested, (S((64, 64), jnp.float32), S((3, 5, 64, 64), jnp.float32)),
               2 * 64**3 * 15),
    "batched_dot": (_batched, (S((4, 32, 48), jnp.float32), S((4, 48, 16), jnp.float32)),
                    2 * 4 * 32 * 48 * 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cost_totals_equal_the_reference(name):
    f, specs, flops = CASES[name]
    hlo = _compile(f, *specs)
    got, want = T.analyze(hlo), J.analyze(hlo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.flops == pytest.approx(flops, rel=0.01)
    assert got.hbm_bytes > 0
    assert T.parse_computations(hlo).keys() == J.parse_computations(hlo).keys()


COLLECTIVE_HLO = """HloModule collectives

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%cond (c: (s32[], f32[16,128])) -> pred[] {
  %c = (s32[], f32[16,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[16,128]{1,0}) %c), index=0
  %n = s32[] constant(6)
  ROOT %lt = pred[] compare(s32[] %i, s32[] %n), direction=LT
}

%body (c: (s32[], f32[16,128])) -> (s32[], f32[16,128]) {
  %c = (s32[], f32[16,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[16,128]{1,0}) %c), index=0
  %x = f32[16,128]{1,0} get-tuple-element((s32[], f32[16,128]{1,0}) %c), index=1
  %r = f32[16,128]{1,0} all-reduce(f32[16,128]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %one = s32[] constant(1)
  %j = s32[] add(s32[] %i, s32[] %one)
  ROOT %t = (s32[], f32[16,128]{1,0}) tuple(s32[] %j, f32[16,128]{1,0} %r)
}

ENTRY %main (p0: f32[16,128], p1: bf16[4,256], p2: s32[8]) -> (f32[16,128], bf16[16,256]) {
  %p0 = f32[16,128]{1,0} parameter(0)
  %p1 = bf16[4,256]{1,0} parameter(1)
  %p2 = s32[8]{0} parameter(2)
  %ar = f32[16,128]{1,0} all-reduce(f32[16,128]{1,0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ags = (bf16[4,256]{1,0}, bf16[16,256]{1,0}) all-gather-start(bf16[4,256]{1,0} %p1), dimensions={0}
  %agd = bf16[16,256]{1,0} all-gather-done((bf16[4,256]{1,0}, bf16[16,256]{1,0}) %ags)
  %rs = f32[4,128]{1,0} reduce-scatter(f32[16,128]{1,0} %ar), dimensions={0}, to_apply=%add
  %a2a = f32[16,128]{1,0} all-to-all(f32[16,128]{1,0} %p0), dimensions={0}
  %cp = s32[8]{0} collective-permute(s32[8]{0} %p2), source_target_pairs={{0,1},{1,2}}
  %zero = s32[] constant(0)
  %init = (s32[], f32[16,128]{1,0}) tuple(s32[] %zero, f32[16,128]{1,0} %a2a)
  %w = (s32[], f32[16,128]{1,0}) while((s32[], f32[16,128]{1,0}) %init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"6"}}
  %out = f32[16,128]{1,0} get-tuple-element((s32[], f32[16,128]{1,0}) %w), index=1
  ROOT %t = (f32[16,128]{1,0}, bf16[16,256]{1,0}) tuple(f32[16,128]{1,0} %out, bf16[16,256]{1,0} %agd)
}
"""

PLAIN_LINES = """
  %x = f32[1024]{0} all-reduce-start(f32[1024]{0} %p), to_apply=%add
  %y = f32[1024]{0} all-reduce-done(f32[1024]{0} %x)
  %z = (f32[2,3]{1,0}, s8[64]{0}) all-to-all(f32[2,3]{1,0} %a, s8[64]{0} %b), dimensions={0}
  %g = f8e4m3fn[32,32]{1,0} all-gather(f8e4m3fn[2,32]{1,0} %q), dimensions={0}
  %n = f32[7]{0} add(f32[7]{0} %u, f32[7]{0} %v)
"""


@pytest.mark.parametrize("hlo", [COLLECTIVE_HLO, PLAIN_LINES], ids=["module", "lines"])
def test_collective_bytes_equal_the_reference(jdryrun, hlo):
    got, want = TD.collective_bytes(hlo), jdryrun.collective_bytes(hlo)
    assert got == want
    assert sum(got["counts"].values()) > 0


def test_collectives_in_the_analyzers():
    got, want = T.analyze(COLLECTIVE_HLO), J.analyze(COLLECTIVE_HLO)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the while body's all-reduce counts six times, beside the entry's one
    assert got.collective_counts["all-reduce"] == 7
    assert got.collective_bytes["all-reduce"] == 7 * 16 * 128 * 4
    assert got.collective_bytes["all-gather"] == (4 + 16) * 256 * 2
    assert got.collective_counts["collective-permute"] == 1
