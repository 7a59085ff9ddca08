"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H, MLA (kv_lora=512, rope 64),
64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer dense
(d_ff 10944), vocab 102400 [arXiv:2405.04434].  SCV-sorted MoE dispatch."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.layers import MLAConfig, MoEConfig
from repro_torch.models.transformer import LMConfig

_full = LMConfig(
    name="deepseek-v2-lite", n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    head_dim=128, d_ff=1408, vocab=102_400,
    mla=MLAConfig(d_model=2048, n_heads=16, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_model=2048, d_ff=1408, n_shared=2),
    first_dense=1, first_dense_ff=10944, kv_quant=True,
)

_reduced = LMConfig(
    name="dsv2-lite-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=32, vocab=512,
    mla=MLAConfig(d_model=64, n_heads=4, kv_lora_rank=16,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared=1,
                  capacity_factor=4.0),
    first_dense=1, first_dense_ff=96, dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=2,
    name="deepseek-v2-lite", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: full attention (MLA)",
    uses_paper_technique=True,
)
