"""Architecture registry machinery.

Port of ``src/repro/configs/common.py``.  Each ``configs/<arch>.py``
exports ``spec: ArchSpec``, which binds a model family to its full-size
config, a reduced same-family config for small runs, and the input
shapes that apply.  The port runs the decoder LM (``kind="lm"``); a
family it does not hold yet raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it, and so does ``make_train_step``.
The abstract-input helpers (``input_specs``, ``state_specs``) wait for
the dry-run slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

#: What brings each family the port does not hold yet (``ROADMAP.md``).
_NOT_PORTED = {
    "mamba_lm": "ROADMAP.md §1 item 6 (ssm.py, hybrid.py, encdec.py and their configs)",
    "hybrid": "ROADMAP.md §1 item 6 (ssm.py, hybrid.py, encdec.py and their configs)",
    "encdec": "ROADMAP.md §1 item 6 (ssm.py, hybrid.py, encdec.py and their configs)",
}
_TRAINING = "ROADMAP.md §1 item 6 (the training stack: optim/, train/, data/, launch/train.py)"


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str  # "lm" | "mamba_lm" | "hybrid" | "encdec" | "gnn"
    config: Any
    reduced: Any
    shapes: tuple = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: str = ""
    uses_paper_technique: bool = False  # SCV-sorted MoE dispatch
    train_microbatch: int = 1  # grad-accumulation splits (activation memory)
    master_weights: bool = False  # bf16 params + f32 master in opt state

    def cfg(self, reduced=False):
        return self.reduced if reduced else self.config

    def _family(self):
        if self.kind == "lm":
            from repro_torch.models import transformer

            return transformer
        if self.kind in _NOT_PORTED:
            raise NotImplementedError(
                f"{self.name}: kind {self.kind!r} is not ported yet; {_NOT_PORTED[self.kind]}"
            )
        raise ValueError(self.kind)

    # -- family dispatch ---------------------------------------------------
    def init(self, generator, reduced=False, device="cuda"):
        """(params, specs) on ``device`` (default the card; raises
        without one), drawn from ``generator``."""
        return self._family().init_lm(generator, self.cfg(reduced), device=device)

    def loss_fn(self, reduced=False) -> Callable:
        train_loss = self._family().train_loss
        cfg = self.cfg(reduced)
        return lambda p, batch: train_loss(p, cfg, batch)

    def make_train_step(self, *args, **kwargs):
        raise NotImplementedError(f"{self.name}: training is not ported yet; {_TRAINING}")

    def make_prefill_step(self, shape: Shape, reduced=False):
        prefill = self._family().prefill
        cfg = self.cfg(reduced)
        S = shape.seq_len if not reduced else min(shape.seq_len, 64)

        def step(params, batch):
            return prefill(params, cfg, batch["tokens"],
                           extra_embed=batch.get("extra_embed"), max_len=S)

        return step

    def make_decode_step(self, shape: Shape, reduced=False):
        decode_step = self._family().decode_step
        cfg = self.cfg(reduced)

        def step(params, state, batch):
            return decode_step(params, cfg, batch["token"], state, batch["pos"])

        return step

    # -- counts, from shapes alone -------------------------------------------
    def _meta_params(self, reduced):
        return self.init(None, reduced, device="meta")[0]

    def param_count(self, reduced=False) -> int:
        from repro_torch.models.transformer import leaf_paths

        return sum(int(np.prod(t.shape)) for _, t in leaf_paths(self._meta_params(reduced)))

    def active_param_count(self, reduced=False) -> int:
        from repro_torch.models.transformer import leaf_paths

        moe = getattr(self.cfg(reduced), "moe", None)
        total = 0
        for keys, t in leaf_paths(self._meta_params(reduced)):
            n = int(np.prod(t.shape))
            if moe is not None and "moe" in keys and (
                keys.endswith("wi") or keys.endswith("wg") or keys.endswith("wo")
            ):
                n = n * moe.top_k // moe.n_experts
            total += n
        return total
