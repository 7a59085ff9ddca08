"""Architecture registry: ``--arch <id>`` resolves here.  ``ARCHS`` holds
the reference's ten architectures: the seven decoder LMs, the SSM
(mamba2-780m), the hybrid (zamba2-2.7b) and the encoder-decoder
(whisper-small)."""
from repro_torch.configs import (
    deepseek_v2_lite,
    gcn_paper,
    gemma2_27b,
    gemma3_4b,
    internvl2_76b,
    mamba2_780m,
    olmoe_1b_7b,
    qwen15_32b,
    starcoder2_15b,
    whisper_small,
    zamba2_2p7b,
)

ARCHS = {
    m.spec.name: m.spec
    for m in (
        gemma2_27b,
        starcoder2_15b,
        gemma3_4b,
        qwen15_32b,
        olmoe_1b_7b,
        deepseek_v2_lite,
        whisper_small,
        mamba2_780m,
        internvl2_76b,
        zamba2_2p7b,
    )
}

GNN_ARCHS = {gcn_paper.spec.name: gcn_paper.spec}


def get(name: str):
    if name in ARCHS:
        return ARCHS[name]
    if name in GNN_ARCHS:
        return GNN_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(GNN_ARCHS)}")
