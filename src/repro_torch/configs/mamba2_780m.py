"""mamba2-780m [ssm]: 48L d=1536, attn-free, ssm_state=128, vocab 50280.
SSD (state-space duality) chunked scan; decode state is O(1) in context
length, so long_500k runs [arXiv:2405.21060]."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.ssm import Mamba2LMConfig

_full = Mamba2LMConfig(
    name="mamba2-780m", n_layers=48, d_model=1536, vocab=50_280,
    d_state=128, headdim=64,
)

_reduced = Mamba2LMConfig(
    name="mamba2-780m-reduced", n_layers=3, d_model=64, vocab=512,
    d_state=16, headdim=16, dtype=torch.float32,
)

spec = ArchSpec(
    name="mamba2-780m", kind="mamba_lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
