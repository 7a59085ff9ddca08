"""qwen1.5-32b [dense]: 64L d=5120 40H (MHA kv=40) d_ff=27392 vocab=152064.
QKV bias, SwiGLU, RMSNorm [hf:Qwen/Qwen1.5-32B]."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig

# int8 KV cache: the 64L x 40H MHA cache at 32k x 128 is 5.5 TB in bf16;
# int8 (+f32 scales) halves it and halves decode read traffic
_full = LMConfig(
    name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    head_dim=128, d_ff=27392, vocab=152_064, qkv_bias=True, kv_quant=True,
)

_reduced = LMConfig(
    name="qwen1.5-32b-reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, qkv_bias=True, dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=4,
    master_weights=True,
    name="qwen1.5-32b", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: full attention",
)
