"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's: every generator's batches equal bit for bit (dtype and
shape included) over seeds, batch ids and sizes; the determinism case of
``tests/test_substrate.py``; ``to_device`` keeps values and dtypes."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp
from repro_torch.train.fault import DataSkipper

CFGS = [dict(vocab=101, seq_len=16, global_batch=4), dict(vocab=50_304, seq_len=33,
                                                         global_batch=3, seed=7, zipf_a=1.1)]


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("cfg", CFGS)
@pytest.mark.parametrize("batch_id", [0, 3, 1 << 19])
def test_token_batch_equals_reference(cfg, batch_id):
    _equal(tp.token_batch(tp.TokenPipelineConfig(**cfg), batch_id),
           jp.token_batch(jp.TokenPipelineConfig(**cfg), batch_id))


@pytest.mark.parametrize("cfg", CFGS)
def test_vlm_and_audio_batches_equal_reference(cfg):
    for i in (0, 5):
        _equal(tp.vlm_batch(tp.TokenPipelineConfig(**cfg), i, n_img=3, d_model=8),
               jp.vlm_batch(jp.TokenPipelineConfig(**cfg), i, n_img=3, d_model=8))
        _equal(tp.audio_batch(tp.TokenPipelineConfig(**cfg), i, n_frames=6, d_model=8),
               jp.audio_batch(jp.TokenPipelineConfig(**cfg), i, n_frames=6, d_model=8))


def test_batch_iterator_equals_reference():
    cfg = CFGS[0]
    got = itertools.islice(tp.batch_iterator(tp.TokenPipelineConfig(**cfg), start_batch=4), 3)
    want = itertools.islice(jp.batch_iterator(jp.TokenPipelineConfig(**cfg), start_batch=4), 3)
    for g, w in zip(got, want):
        _equal(g, w)


def test_config_fields_match_reference():
    assert (dataclasses.asdict(tp.TokenPipelineConfig(vocab=9, seq_len=2, global_batch=1))
            == dataclasses.asdict(jp.TokenPipelineConfig(vocab=9, seq_len=2, global_batch=1)))


def test_data_skipper_deterministic():
    cfg = tp.TokenPipelineConfig(vocab=101, seq_len=16, global_batch=4)
    sk = DataSkipper(seed=0)
    assert [sk.next_batch_id() for _ in range(5)] == list(range(5))
    sk2 = DataSkipper(seed=0)
    sk2.skip_to(3)
    assert sk2.next_batch_id() == 3
    np.testing.assert_array_equal(tp.token_batch(cfg, 3)["tokens"],
                                  tp.token_batch(cfg, 3)["tokens"])
    assert not np.array_equal(tp.token_batch(cfg, 3)["tokens"], tp.token_batch(cfg, 4)["tokens"])


def test_to_device_keeps_values_and_dtypes():
    b = tp.audio_batch(tp.TokenPipelineConfig(**CFGS[0]), 2, n_frames=5, d_model=4)
    t = tp.to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["frames"].dtype == torch.float32
    for k in b:
        np.testing.assert_array_equal(t[k].numpy(), b[k])
