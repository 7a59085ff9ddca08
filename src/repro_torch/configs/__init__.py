"""Architecture registry: ``--arch <id>`` resolves here.  ``ARCHS`` holds
the decoder LMs the port runs; the SSM, hybrid and encoder-decoder archs
join it with their models (``ROADMAP.md`` §1 item 6)."""
from repro_torch.configs import (
    deepseek_v2_lite,
    gcn_paper,
    gemma2_27b,
    gemma3_4b,
    internvl2_76b,
    olmoe_1b_7b,
    qwen15_32b,
    starcoder2_15b,
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
        internvl2_76b,
    )
}

GNN_ARCHS = {gcn_paper.spec.name: gcn_paper.spec}


def get(name: str):
    if name in ARCHS:
        return ARCHS[name]
    if name in GNN_ARCHS:
        return GNN_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(GNN_ARCHS)}")
