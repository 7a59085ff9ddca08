"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The InternViT frontend is a stub (precomputed patch embeddings prepended);
the LM backbone (Llama-3-70B-style) is real [arXiv:2404.16821]."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig

_full = LMConfig(
    name="internvl2-76b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=28672, vocab=128_256, rope_base=500_000.0,
    n_frontend_tokens=256,
    kv_quant=True,
)

_reduced = LMConfig(
    name="internvl2-76b-reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, rope_base=500_000.0,
    n_frontend_tokens=8, dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=4,
    name="internvl2-76b", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: full attention",
)
