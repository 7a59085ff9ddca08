"""whisper-small [audio]: 12+12L d=768 12H d_ff=3072 vocab=51865, enc-dec.
Conv frontend is a STUB, as in the reference: the caller supplies
precomputed frame embeddings [arXiv:2212.04356]."""
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.models.encdec import EncDecConfig

_full = EncDecConfig(
    name="whisper-small", n_layers=12, d_model=768, n_heads=12, d_ff=3072,
    vocab=51_865, max_positions=32_768 + 8,
)

_reduced = EncDecConfig(
    name="whisper-small-reduced", n_layers=2, d_model=64, n_heads=4, d_ff=128,
    vocab=512, max_positions=128, dtype=torch.float32,
)

spec = ArchSpec(
    name="whisper-small", kind="encdec", config=_full, reduced=_reduced,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_notes="long_500k skipped: full attention enc-dec",
)
