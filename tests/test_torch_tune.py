"""The port's autotuner (``repro_torch.tune``) against the reference's on
the same inputs: histogram quantization and signatures, the machine
fingerprint (whose device half names the torch device, so it never equals
the reference's), ``TunedConfig`` JSON both ways, ``predict_cost`` field
for field, stage 1's candidate list (configs, order and scores) and
``spearman``; then the port's own store, staleness and stage 2 on the
CPU, where it times the plain SCV path under the host clock."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core.formats import COOMatrix as JCOO
from repro.simul.machine import MachineConfig as JMachine
from repro.tune import Autotuner as JAutotuner
from repro.tune import TunedConfig as JTuned
from repro.tune import TuneStore as JStore
from repro.tune import autotuner as jautotuner
from repro.tune import cost as jcost
from repro.tune import signature as jsig
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import DEFAULT_LADDER, DEFAULT_TILE, tile_nnz_histogram
from repro_torch.simul.datasets import gcn_normalize, powerlaw_edges, powerlaw_graph
from repro_torch.simul.machine import MachineConfig
from repro_torch.tune import (
    Autotuner,
    TunedConfig,
    TuneStore,
    autotuner,
    cache_key,
    histogram_signature,
    machine_fingerprint,
    predict_cost,
    quantize_histogram,
    spearman,
)
from repro_torch.tune.signature import device_tag


def _empty(n=128):
    z = np.zeros(0, np.int32)
    return COOMatrix(z, z.copy(), np.zeros(0, np.float32), (n, n))


GRAPHS = {
    "powerlaw 4096/60k": lambda: powerlaw_graph(4096, 60_000, seed=0),
    "powerlaw_edges 512/60k": lambda: powerlaw_edges(512, 60_000, seed=0),
    "empty": _empty,
}


@pytest.fixture(scope="module")
def graphs():
    return {k: make() for k, make in GRAPHS.items()}


def _j(a):
    return JCOO(a.rows, a.cols, a.vals, a.shape)


def _jcfg(c):
    return JTuned.from_json(c.to_json())


# ---------------------------------------------------------------------------
# signatures and fingerprints
# ---------------------------------------------------------------------------
def _histograms():
    rng = np.random.default_rng(0)
    return {
        "empty": np.zeros(0, np.int64),
        "zeros": np.zeros(5, np.int64),
        "random": rng.integers(1, 4097, 3000),
        "sparse graph": tile_nnz_histogram(powerlaw_graph(1 << 13, 120_000, seed=0), 64),
        "dense graph": tile_nnz_histogram(gcn_normalize(powerlaw_graph(256, 30_000)), 64),
    }


@pytest.mark.parametrize("name", sorted(_histograms()))
@pytest.mark.parametrize("tile", [32, 64, 128])
def test_histogram_quantization_equals_reference(name, tile):
    counts = _histograms()[name]
    assert quantize_histogram(counts, tile) == jsig.quantize_histogram(counts, tile)
    assert histogram_signature(counts, tile) == jsig.histogram_signature(counts, tile)
    assert histogram_signature(counts) == jsig.histogram_signature(counts)


@pytest.mark.parametrize("fields", [{}, {"dram_gbps": 2.0}, {"n_vpe": 16, "cache_bytes": 1 << 20}])
def test_machine_fingerprint_names_the_torch_device(fields):
    m, jm = MachineConfig(**fields), JMachine(**fields)
    assert m.fingerprint() == jm.fingerprint()
    ours, theirs = machine_fingerprint(m, "cpu"), jsig.machine_fingerprint(jm)
    assert ours == f"{m.fingerprint()}-torch-cpu"
    assert ours != theirs and ours.startswith(m.fingerprint())
    assert cache_key("abc", ours) == jsig.cache_key("abc", ours)


def test_device_tag_never_a_jax_backend(monkeypatch):
    assert device_tag("cpu") == "torch-cpu"
    assert machine_fingerprint(device="cpu").endswith("-torch-cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert device_tag("cuda") == "torch-cuda-NVIDIA_H100_80GB_HBM3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        machine_fingerprint()


# ---------------------------------------------------------------------------
# TunedConfig
# ---------------------------------------------------------------------------
CONFIGS = [
    TunedConfig(),
    TunedConfig(tile=128, chunk=64, bucket_caps=(16, 64, 256), source="calibrated"),
    TunedConfig(tile=32, chunk=256, dense_threshold_ratio=0.125, bucket_caps=(8,)),
    TunedConfig(bucket_caps=(), cap=16, source="cache"),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_tuned_config_json_equals_reference_both_ways(cfg):
    j = _jcfg(cfg)
    assert cfg.to_json() == j.to_json()
    assert json.dumps(cfg.to_json()) == json.dumps(j.to_json())
    back = TunedConfig.from_json(j.to_json())
    assert back == cfg and back.source == cfg.source
    assert JTuned.from_json(cfg.to_json()).plan_key == cfg.plan_key
    assert cfg.dense_tile_threshold() == j.dense_tile_threshold()
    assert cfg.cap_signature == j.cap_signature


def test_tuned_config_default_equals_reference():
    assert TunedConfig.default().to_json() == JTuned.default().to_json()
    assert TunedConfig.from_json({"tile": 64, "chunk": 128, "dense_threshold_ratio": 0.5,
                                  "bucket_caps": [8]}).to_json() == JTuned.from_json(
        {"tile": 64, "chunk": 128, "dense_threshold_ratio": 0.5, "bucket_caps": [8]}).to_json()


# ---------------------------------------------------------------------------
# predict_cost and stage 1
# ---------------------------------------------------------------------------
def _assert_rel(got: float, want: float, what):
    assert abs(got - want) <= 1e-12 * max(abs(want), 1e-300), (what, got, want)


@pytest.mark.parametrize("name", ["powerlaw 4096/60k", "powerlaw_edges 512/60k"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
@pytest.mark.parametrize("shared", [False, True])
def test_predict_cost_equals_reference(graphs, name, cfg, shared):
    a = graphs[name]
    compute = jcompute = None
    if shared:  # stage 1's path: one simulator run per tile, re-priced per ladder
        from repro.simul.dataflows import run_scv_bucketed as jrun
        from repro_torch.simul.dataflows import run_scv_bucketed

        compute = run_scv_bucketed(a, 64, MachineConfig(), cfg.tile)
        jcompute = jrun(_j(a), 64, JMachine(), cfg.tile)
    got = predict_cost(a, cfg, 64, compute=compute)
    want = jcost.predict_cost(_j(a), _jcfg(cfg), 64, compute=jcompute)
    for f, w in dataclasses.asdict(want).items():
        g = getattr(got, f)
        if isinstance(w, int):
            assert g == w, f
        else:
            _assert_rel(g, w, f)
    assert got.to_json().keys() == want.to_json().keys()


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("n_feat", [16, 64])
def test_stage1_equals_reference(graphs, name, n_feat):
    a = graphs[name]
    got = Autotuner(calibrate=False, device="cpu")._stage1(a, n_feat)
    want = JAutotuner(calibrate=False)._stage1(_j(a), n_feat)
    assert [c.config.to_json() for c in got] == [c.config.to_json() for c in want]
    for g, w in zip(got, want):
        _assert_rel(g.score_s, w.score_s, g.config)
        _assert_rel(g.estimate.seconds, w.estimate.seconds, g.config)
        assert g.to_json().keys() == w.to_json().keys()


@pytest.mark.parametrize("name", ["powerlaw 4096/60k", "powerlaw_edges 512/60k"])
@pytest.mark.parametrize("tile", [32, 64, 128])
def test_candidate_ladders_and_segment_counts_equal_reference(graphs, name, tile):
    counts = tile_nnz_histogram(graphs[name], tile)
    ladders = autotuner.candidate_ladders(counts, tile)
    assert ladders == jautotuner.candidate_ladders(counts, tile)
    for caps in ladders:
        assert autotuner._segment_tile_counts(counts, caps) == \
            jautotuner._segment_tile_counts(counts, caps)


def test_tune_without_calibration_resolves_like_reference(graphs):
    for name in ("powerlaw 4096/60k", "powerlaw_edges 512/60k"):
        a = graphs[name]
        t, jt = Autotuner(calibrate=False, device="cpu"), JAutotuner(calibrate=False)
        got, want = t.tune(a, n_features=16), jt.tune(_j(a), n_features=16)
        assert got.to_json() == want.to_json()
        assert got.source == "simulated"
        assert t.last_result.key.split("@")[0] == jt.last_result.key.split("@")[0]
        assert t.last_result.key != jt.last_result.key


def test_empty_graph_resolves_to_default(graphs):
    t = Autotuner(calibrate=False, device="cpu")
    assert t.tune(graphs["empty"]) == TunedConfig.default()
    assert t.searches == 0


@pytest.mark.parametrize("seed", range(4))
def test_spearman_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12))
    xs = rng.standard_normal(n)
    ys = rng.integers(0, 4, n).astype(float)  # ties
    assert spearman(xs, ys) == jautotuner.spearman(xs, ys)
    assert spearman(ys, ys) == jautotuner.spearman(ys, ys)
    assert spearman([1.0], [2.0]) == jautotuner.spearman([1.0], [2.0]) == 1.0
    assert spearman([1, 1], [2, 3]) == jautotuner.spearman([1, 1], [2, 3]) == 0.0


# ---------------------------------------------------------------------------
# the store and staleness
# ---------------------------------------------------------------------------
def test_store_round_trips_on_disk(tmp_path):
    path = tmp_path / "tune.json"
    s1 = TuneStore(path)
    assert s1.get("k") is None
    cfg = TunedConfig(tile=128, bucket_caps=(16, 64), source="calibrated")
    s1.put("k", cfg, meta={"note": 1})
    s2 = TuneStore(path)
    got = s2.get("k")
    assert got == cfg and got.source == "calibrated"
    assert (s1.misses, s2.hits, len(s2)) == (1, 1, 1)
    # the reference reads the same file
    assert JStore(path).get("k").to_json() == cfg.to_json()
    assert not list(tmp_path.glob("*.tmp"))  # the write renamed its temp file


@pytest.mark.parametrize("text", ["{not json", '{"version": 2, "entries": {"k": {}}}'])
def test_store_reads_a_corrupt_or_foreign_file_as_empty(tmp_path, text):
    path = tmp_path / "tune.json"
    path.write_text(text)
    s = TuneStore(path)
    assert len(s) == 0 and s.get("k") is None


def test_reference_store_misses_in_the_port(graphs, tmp_path):
    """A store the reference wrote for the same graph hands the port
    nothing: the keys differ in their device half, so the port searches."""
    a = graphs["powerlaw 4096/60k"]
    path = tmp_path / "tune.json"
    jt = JAutotuner(store=JStore(path), calibrate=False)
    jt.tune(_j(a), n_features=16)
    t = Autotuner(store=TuneStore(path), calibrate=False, device="cpu")
    t.tune(a, n_features=16)
    assert (t.searches, t.cache_hits) == (1, 0)
    assert len(TuneStore(path)) == 2
    # and each finds its own entry again
    assert Autotuner(store=TuneStore(path), calibrate=False, device="cpu").tune(a, 16)
    t2 = Autotuner(store=TuneStore(path), calibrate=False, device="cpu")
    t2.tune(a, n_features=16)
    assert (t2.searches, t2.cache_hits) == (0, 1)


def test_machine_change_makes_the_cache_stale(graphs, tmp_path):
    a = graphs["powerlaw 4096/60k"]
    store = TuneStore(tmp_path / "tune.json")
    first = Autotuner(store=store, calibrate=False, device="cpu")
    first.tune(a, n_features=16)
    first.tune(a, n_features=16)
    assert (first.searches, first.cache_hits) == (1, 1)
    other = Autotuner(machine=MachineConfig(dram_gbps=4.0), store=store,
                      calibrate=False, device="cpu")
    other.tune(a, n_features=16)
    assert other.searches == 1 and len(store) == 2


# ---------------------------------------------------------------------------
# stage 2 on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["powerlaw 4096/60k", "powerlaw_edges 512/60k"])
def test_stage2_measures_default_control_and_picks_the_best(graphs, name):
    a = graphs[name]
    t = Autotuner(top_k=2, calib_reps=2, device="cpu")
    cfg = t.tune(a, n_features=16)
    res = t.last_result
    assert cfg.source == "calibrated" and res.rank_correlation is not None
    measured = [(c.config.tile, c.config.bucket_caps) for c in res.calibrated]
    assert (DEFAULT_TILE, DEFAULT_LADDER) in measured
    assert len(measured) == len(set(measured)) <= 3
    assert all(c.measured_s > 0 for c in res.calibrated)
    best = min(res.calibrated, key=lambda c: c.measured_s)
    assert (cfg.tile, cfg.bucket_caps) == (best.config.tile, best.config.bucket_caps)
    assert res.rank_correlation == spearman([c.score_s for c in res.calibrated],
                                            [c.measured_s for c in res.calibrated])
    # the survivors are stage 1's leaders, in the reference's order
    want = JAutotuner(calibrate=False)._stage1(_j(a), 16)
    lead = []
    for c in want:
        k = (c.config.tile, c.config.bucket_caps)
        if k not in lead:
            lead.append(k)
    assert measured[:2] == lead[:2]


def test_stage2_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Autotuner()
