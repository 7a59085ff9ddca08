"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local(4096)+global alternating, attn/final logit softcaps, post-norms,
query_pre_attn_scalar=144 [arXiv:2408.00118]."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig

_full = LMConfig(
    name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    head_dim=128, d_ff=36864, vocab=256_000, act="gelu_tanh",
    attn_softcap=50.0, final_softcap=30.0, embed_scale=True, post_norms=True,
    layer_pattern=("l", "g"), window=4096, query_scale=144.0 ** -0.5,
    kv_quant=True,
)

_reduced = LMConfig(
    name="gemma2-27b-reduced", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, act="gelu_tanh",
    attn_softcap=50.0, final_softcap=30.0, embed_scale=True, post_norms=True,
    layer_pattern=("l", "g"), window=16, query_scale=16.0 ** -0.5,
    dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=2,
    name="gemma2-27b", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: global layers are full attention (DESIGN.md §4)",
)
