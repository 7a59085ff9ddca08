"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d=2560 (ssm_state=64) + one
SHARED attention block (32H) invoked every 6 blocks, d_ff=10240,
vocab 32000 [arXiv:2411.15242].  Hybrid state = O(window + d_state), so
long_500k runs (shared-attn cache is windowed)."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.hybrid import HybridConfig

_full = HybridConfig(
    name="zamba2-2.7b", n_mamba=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32_000, d_state=64, headdim=64, share_every=6,
    window=4096,
)

_reduced = HybridConfig(
    name="zamba2-2.7b-reduced", n_mamba=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, d_state=16, headdim=16, share_every=2, window=16,
    dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=2,
    name="zamba2-2.7b", kind="hybrid", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
