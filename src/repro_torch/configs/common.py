"""Architecture registry machinery.

Port of ``src/repro/configs/common.py``.  Each ``configs/<arch>.py``
exports ``spec: ArchSpec``, which binds a model family (``lm``,
``mamba_lm``, ``hybrid``, ``encdec``) to its full-size config, a reduced
same-family config for small runs, and the input shapes that apply.
Every family inits, computes its loss forward and makes its prefill and
decode steps; ``make_train_step`` raises, naming the ``ROADMAP.md`` item
that brings the training stack.  The abstract-input helpers
(``input_specs``, ``state_specs``) wait for the dry-run slice.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import numpy as np

#: Each family's module under ``repro_torch.models`` and its init, loss
#: and decode functions there.
_FAMILIES = {
    "lm": ("transformer", "init_lm", "train_loss", "decode_step"),
    "mamba_lm": ("ssm", "init_mamba2_lm", "mamba2_lm_loss", "mamba2_lm_decode"),
    "hybrid": ("hybrid", "init_hybrid", "train_loss", "decode_step"),
    "encdec": ("encdec", "init_encdec", "train_loss", "decode_step"),
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

    # -- family dispatch ---------------------------------------------------
    def _entry(self, role: str) -> Callable:
        """The family's ``init``, ``loss`` or ``decode`` function."""
        if self.kind not in _FAMILIES:
            raise ValueError(self.kind)
        module, *names = _FAMILIES[self.kind]
        mod = importlib.import_module(f"repro_torch.models.{module}")
        return getattr(mod, names[("init", "loss", "decode").index(role)])

    def init(self, generator, reduced=False, device="cuda"):
        """(params, specs) on ``device`` (default the card; raises
        without one), drawn from ``generator``."""
        return self._entry("init")(generator, self.cfg(reduced), device=device)

    def loss_fn(self, reduced=False) -> Callable:
        train_loss = self._entry("loss")
        cfg = self.cfg(reduced)
        return lambda p, batch: train_loss(p, cfg, batch)

    def make_train_step(self, *args, **kwargs):
        raise NotImplementedError(f"{self.name}: training is not ported yet; {_TRAINING}")

    def make_prefill_step(self, shape: Shape, reduced=False):
        cfg = self.cfg(reduced)
        S = shape.seq_len if not reduced else min(shape.seq_len, 64)
        if self.kind == "lm":
            from repro_torch.models.transformer import prefill

            def step(params, batch):
                return prefill(params, cfg, batch["tokens"],
                               extra_embed=batch.get("extra_embed"), max_len=S)

        elif self.kind in ("mamba_lm", "hybrid"):
            from repro_torch.models.layers import unembed_logits

            if self.kind == "mamba_lm":
                from repro_torch.models.ssm import mamba2_lm_hidden as hidden
            else:
                from repro_torch.models.hybrid import hidden_states as hidden

            def step(params, batch):
                x, _ = hidden(params, cfg, batch["tokens"])
                return unembed_logits(params["embed"], x[:, -1:], true_vocab=cfg.vocab)

        elif self.kind == "encdec":
            from repro_torch.models.encdec import encode, init_dec_cache

            def step(params, batch):
                enc = encode(params, cfg, batch["frames"])
                return init_dec_cache(params, cfg, enc, max_len=8)

        else:
            raise ValueError(self.kind)
        return step

    def make_decode_step(self, shape: Shape, reduced=False):
        decode_step = self._entry("decode")
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
