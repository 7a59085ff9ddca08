"""The port's fault-tolerance pieces (``repro_torch.train.fault``): the
fault cases of ``tests/test_substrate.py`` and ``tests/test_train_stack.py``
on the port, and the same verdicts as the reference's on the same inputs."""
import numpy as np
import pytest

from repro.train import fault as jf
from repro_torch.train import fault


def test_module_is_documented():
    assert fault.__doc__


def test_heartbeat_detects_dead():
    hb = fault.Heartbeat(timeout_s=10)
    hb.beat(0, now=100.0)
    hb.beat(1, now=105.0)
    assert hb.dead_workers([0, 1], now=112.0) == [0]
    assert hb.dead_workers([0, 1, 2], now=112.0) == [0, 2]


def test_heartbeat_deadline():
    hb = fault.Heartbeat(timeout_s=10.0)
    hb.beat(0, now=100.0)
    hb.beat(1, now=105.0)
    assert hb.dead_workers([0, 1], now=109.0) == []
    assert hb.dead_workers([0, 1], now=112.0) == [0]
    # a never-seen worker is dead by definition
    assert hb.dead_workers([0, 1, 2], now=109.0) == [2]


def test_straggler_detector_flags_slow_worker():
    det = fault.StragglerDetector(k_sigma=3.0, patience=3)
    flagged = False
    for i in range(20):
        flagged = det.observe(0, 1.0 + 0.01 * np.sin(i))
    assert not flagged
    for _ in range(3):
        flagged = det.observe(0, 5.0)
    assert flagged


def test_straggler_detector_flags_consistent_outlier():
    det = fault.StragglerDetector(k_sigma=3.0, patience=3)
    for _ in range(20):
        assert not det.observe(0, 1.0)
    assert [det.observe(0, 10.0) for _ in range(3)] == [False, False, True]


def test_straggler_detector_recovers():
    det = fault.StragglerDetector(k_sigma=3.0, patience=3)
    for _ in range(20):
        det.observe(0, 1.0)
    det.observe(0, 10.0)
    det.observe(0, 10.0)
    assert not det.observe(0, 1.0)  # strike streak reset
    assert not det.observe(0, 10.0)  # streak restarts from zero


def test_straggler_verdicts_equal_reference():
    """A seeded stream of step times over three workers, one of them slow
    in bursts: the same flags, step for step."""
    rng = np.random.default_rng(0)
    times = 1.0 + 0.05 * rng.standard_normal((200, 3))
    times[60:66, 1] += 4.0
    times[120:121, 2] += 9.0
    got, want = fault.StragglerDetector(), jf.StragglerDetector()
    for step in times:
        for w, t in enumerate(step):
            assert got.observe(w, float(t)) == want.observe(w, float(t))


@pytest.mark.parametrize("n,mp,want", [(256, 16, (16, 16)), (240, 16, (15, 16)),
                                       (512, 16, (32, 16)), (64, 16, (4, 16)),
                                       (63, 16, (3, 16)), (8, 16, (1, 16))])
def test_elastic_mesh_shapes(n, mp, want):
    assert fault.elastic_mesh_shapes(n, model_parallel=mp) == want == jf.elastic_mesh_shapes(n, mp)


def test_data_skipper_deterministic_resume():
    fresh = fault.DataSkipper(seed=0)
    ids = [fresh.next_batch_id() for _ in range(10)]
    resumed = fault.DataSkipper(seed=0)
    resumed.skip_to(step=4, batches_per_step=2)
    assert [resumed.next_batch_id() for _ in range(2)] == ids[8:10]
