"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
GQA + RoPE (theta 1e5), LayerNorm, non-gated GeLU MLP, bias terms
[arXiv:2402.19173]."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig

_full = LMConfig(
    name="starcoder2-15b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    head_dim=128, d_ff=24576, vocab=49_152, norm="layernorm", act="gelu_tanh",
    gated=False, qkv_bias=True, rope_base=100_000.0,
    kv_quant=True,
)

_reduced = LMConfig(
    name="starcoder2-15b-reduced", n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
    head_dim=8, d_ff=128, vocab=512, norm="layernorm", act="gelu_tanh",
    gated=False, qkv_bias=True, rope_base=100_000.0, dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=2,
    name="starcoder2-15b", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: full attention",
)
