"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local(1024):global pattern, dual rope bases (10k local / 1M global)
[hf:google/gemma-3-4b-pt].  34 = 4 leading global + 5 x (5 local + 1 global);
the leading remainder is realized via first_dense globals."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import LMConfig

_full = LMConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    head_dim=256, d_ff=10240, vocab=262_144, act="gelu_tanh",
    embed_scale=True, post_norms=True,
    layer_pattern=("l", "l", "l", "l", "l", "g"), window=1024,
    rope_base=1_000_000.0, rope_base_local=10_000.0,
    first_dense=4, first_dense_ff=10240,
    kv_quant=True,
)

# reduced keeps the FULL structural skeleton (first_dense count, pattern)
# so its logical-axes tree matches the full config's param tree
_reduced = LMConfig(
    name="gemma3-4b-reduced", n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, act="gelu_tanh",
    embed_scale=True, post_norms=True,
    layer_pattern=("l", "l", "l", "l", "l", "g"), window=16,
    rope_base=1_000_000.0, rope_base_local=10_000.0,
    first_dense=4, first_dense_ff=128, dtype=torch.float32,
)

spec = ArchSpec(
    train_microbatch=2,
    name="gemma3-4b", kind="lm", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: global layers are full attention",
)
