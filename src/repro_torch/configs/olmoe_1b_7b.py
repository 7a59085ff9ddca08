"""olmoe-1b-7b [moe]: 16L d=2048 16H d_ff(expert)=1024, 64 experts top-8,
vocab 50304 [arXiv:2409.02060].  Uses the SCV-inspired sorted dispatch —
the paper's technique applied to the token->expert ultra-sparse matrix."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import LMConfig

_full = LMConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    head_dim=128, d_ff=1024, vocab=50_304,
    moe=MoEConfig(n_experts=64, top_k=8, d_model=2048, d_ff=1024,
                  capacity_factor=1.0),
)

_reduced = LMConfig(
    name="olmoe-reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=32, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32, capacity_factor=4.0),
    dtype=torch.float32,
)

spec = ArchSpec(
    name="olmoe-1b-7b", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: full attention",
    uses_paper_technique=True,
)
