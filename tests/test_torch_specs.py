"""``ArchSpec.input_specs`` and ``ArchSpec.state_specs`` of the port
against the reference's (``src/repro/configs/common.py``), for every arch,
every shape it lists and both sizes: the same keys (by leaf path), shapes
and dtypes as the reference's ``ShapeDtypeStruct``s (no allocation on
either side: the port's stand-ins are tensors on ``meta``), and equal
logical-axes trees."""
import jax
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs.common import SHAPES
from repro_torch.models.transformer import leaf_paths

CELLS = [(a, s, r) for a in sorted(J_ARCHS) for s in J_ARCHS[a].shapes for r in (True, False)]


def _jpaths(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(jtree, ttree):
    assert set(jtree) == set(ttree)
    for k, j in jtree.items():
        t = ttree[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(j.shape), (k, t.shape, j.shape)
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (k, t.dtype, j.dtype)


@pytest.mark.parametrize("arch,shape,reduced", CELLS)
def test_input_specs_equal_the_reference(arch, shape, reduced):
    want = J_ARCHS[arch].input_specs(shape, reduced)
    got = T_ARCHS[arch].input_specs(shape, reduced)
    assert list(got) == list(want)
    _same(_jpaths(want), dict(leaf_paths(got)))


@pytest.mark.parametrize("arch,shape,reduced",
                         [c for c in CELLS if SHAPES[c[1]].kind == "decode"])
def test_state_specs_equal_the_reference(arch, shape, reduced):
    jshapes, jaxes = J_ARCHS[arch].state_specs(shape, reduced)
    tshapes, taxes = T_ARCHS[arch].state_specs(shape, reduced)
    _same(_jpaths(jshapes), dict(leaf_paths(tshapes)))
    assert taxes == jaxes


def test_the_frontend_and_encoder_leaves_are_there():
    vlm = T_ARCHS["internvl2-76b"]
    assert set(vlm.input_specs("train_4k")) == {"tokens", "extra_embed"}
    assert set(vlm.input_specs("prefill_32k", reduced=True)) == {"tokens", "extra_embed"}
    whisper = T_ARCHS["whisper-small"]
    assert list(whisper.input_specs("train_4k")) == ["frames", "tokens"]
    assert list(whisper.input_specs("prefill_32k")) == ["frames"]
    state, axes = whisper.state_specs("decode_32k")
    assert {"xk", "xv", "k", "v", "pos", "len"} == set(state) == set(axes)
    with pytest.raises(KeyError):
        whisper.input_specs("train_8k")
