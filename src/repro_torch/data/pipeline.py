"""Deterministic synthetic data pipelines.

Port of ``src/repro/data/pipeline.py``, whose generators are numpy and run
here unchanged: a batch is a pure function of (seed, batch_id), so a run is
restartable and skippable with no coordination (``train/fault.py``'s
``DataSkipper``), and its batches equal the reference's bit for bit.  The
token draw is Zipfian, as a tokenized web corpus is.  Batches stay on the
host; :func:`to_device` moves one to the model's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def token_batch(cfg: TokenPipelineConfig, batch_id: int) -> dict:
    """Host-side batch synthesis (numpy; cheap and deterministic)."""
    rng = np.random.default_rng((cfg.seed << 20) ^ batch_id)
    # Zipf capped into vocab; guarantees full-range coverage over time
    z = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = (z - 1) % cfg.vocab
    return {"tokens": toks.astype(np.int32)}


def batch_iterator(cfg: TokenPipelineConfig, start_batch: int = 0):
    i = start_batch
    while True:
        yield token_batch(cfg, i)
        i += 1


def vlm_batch(cfg: TokenPipelineConfig, batch_id: int, n_img: int, d_model: int) -> dict:
    b = token_batch(cfg, batch_id)
    rng = np.random.default_rng((cfg.seed << 21) ^ batch_id)
    b["extra_embed"] = rng.standard_normal(
        (cfg.global_batch, n_img, d_model)
    ).astype(np.float32)
    return b


def audio_batch(cfg: TokenPipelineConfig, batch_id: int, n_frames: int, d_model: int) -> dict:
    b = token_batch(cfg, batch_id)
    rng = np.random.default_rng((cfg.seed << 22) ^ batch_id)
    b["frames"] = rng.standard_normal(
        (cfg.global_batch, n_frames, d_model)
    ).astype(np.float32)
    return b


def to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
