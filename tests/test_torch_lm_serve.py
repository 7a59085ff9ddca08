"""The port's LM serving (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) against the reference's: the same requests
through both engines give the same tokens (argmax over float32 logits
that agree within 1e-4, so the picks agree), greedy decoding equals
repeated full forwards, the launcher's functions give the reference
launcher's tokens on the same weights for a decoder LM, the SSM and the
hybrid (recurrent prefill through the decode step), the captured decode
counts one key per batch shape and equals the plain step on the CPU, and
the launcher serves on the CPU when asked, refuses the encoder-decoder
and refuses without a card otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import transformer as JT
from repro.serve import engine as jeng
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as teng

ARCH = "gemma2-27b"
MAX_LEN = 24


def _requests(mod, cfg):
    rng = np.random.default_rng(4)
    # three prompt lengths: the engine left-pads each batch to its longest
    lens, news = (8, 5, 11, 3, 8), (4, 6, 1, 5, 3)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                        max_new=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_engine_matches_reference_engine():
    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    jcfg, tcfg = jspec.cfg(reduced=True), tspec.cfg(reduced=True)
    jp, _ = jspec.init(jax.random.PRNGKey(0), reduced=True)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")

    jengine = jeng.ServeEngine(
        jp, jax.jit(lambda p, t: JT.prefill(p, jcfg, t, max_len=MAX_LEN)),
        jax.jit(lambda p, s, t, pos: JT.decode_step(p, jcfg, t, s, pos)),
        jeng.EngineConfig(max_batch=2))
    tengine = teng.ServeEngine(
        tp, lambda p, t: TT.prefill(p, tcfg, t, max_len=MAX_LEN),
        lambda p, s, t, pos: TT.decode_step(p, tcfg, t, s, pos),
        teng.EngineConfig(max_batch=2), device="cpu")
    for r in _requests(jeng, jcfg):
        jengine.submit(r)
    for r in _requests(teng, tcfg):
        tengine.submit(r)
    want = {r.rid: r.out for r in jengine.run()}
    got = tengine.run()
    assert [r.rid for r in got] == sorted(want)
    for r in got:
        assert r.done and len(r.out) == r.max_new
        assert r.out == want[r.rid], r.rid


def test_greedy_matches_direct():
    """Engine decode tokens == greedy tokens from repeated full forwards
    (the port of the reference's ``test_serve_greedy_matches_direct``)."""
    spec = T_ARCHS[ARCH]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 8).astype(np.int32)
    eng = teng.ServeEngine(
        params, lambda p, t: TT.prefill(p, cfg, t, max_len=16),
        lambda p, s, t, pos: TT.decode_step(p, cfg, t, s, pos),
        teng.EngineConfig(max_batch=1), device="cpu")
    eng.submit(teng.Request(rid=0, prompt=prompt, max_new=4))
    out = eng.run()[0].out

    toks = list(prompt)
    for _ in range(4):
        x, _, _ = TT.hidden_states(params, cfg, torch.tensor([toks], dtype=torch.int32))
        logits = TL.unembed_logits(params["embed"], x[:, -1:], cfg.final_softcap,
                                   true_vocab=cfg.vocab)
        toks.append(int(torch.argmax(logits[0, -1])))
    assert out == toks[len(prompt):], (out, toks[len(prompt):])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_launcher_serves_on_cpu(arch, capsys):
    done = tserve.main(["--arch", arch, "--requests", "5", "--prompt-len", "6",
                        "--max-new", "4", "--max-batch", "2", "--device", "cpu"])
    assert len(done) == 5
    assert all(r.done and len(r.out) == 4 for r in done)
    assert all(0 <= t < T_ARCHS[arch].cfg(reduced=True).vocab for r in done for t in r.out)
    assert "served 5 requests, 20 tokens" in capsys.readouterr().out


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", ARCH, "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.ServeEngine({}, None, None, teng.EngineConfig())


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b", "olmoe-1b-7b"])
def test_launcher_matches_reference_launcher(arch, monkeypatch, capsys):
    """Both launchers' ``main`` on the same arguments, the port's serving
    the reference's weights (its init replaced by the carrier): the same
    tokens for every request.  The recurrent kinds prefill through the
    decode step, one token at a time, in both."""
    from repro.launch import serve as jserve
    from repro_torch.configs.common import ArchSpec

    jp, _ = J_ARCHS[arch].init(jax.random.PRNGKey(0), reduced=True)
    carried = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(ArchSpec, "init", lambda self, *a, **k: (carried, None))
    args = ["--arch", arch, "--requests", "3", "--prompt-len", "5", "--max-new", "3",
            "--max-batch", "2"]
    want = [r.out for r in jserve.main(args)]
    got = [r.out for r in tserve.main(args + ["--device", "cpu"])]
    assert got == want


def test_serve_fns_refuses_the_encoder_decoder():
    spec = T_ARCHS["whisper-small"]
    with pytest.raises(SystemExit, match="encdec has its own path"):
        tserve.serve_fns(spec, spec.cfg(reduced=True), 16, "cpu")
    with pytest.raises(SystemExit, match="encdec has its own path"):
        tserve.main(["--arch", "whisper-small", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b", "gemma2-27b"])
def test_captured_decode_on_cpu(arch):
    """On the CPU the captured decode runs the step eagerly and counts one
    key per (batch size, ``max_len``): its tokens and logits equal the
    plain step's, and a second batch size mints a second key."""
    spec = T_ARCHS[arch]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    outs = {}
    for capture in (True, False):
        prefill_fn, decode_fn = tserve.serve_fns(spec, cfg, 12, "cpu", capture=capture)
        eng = teng.ServeEngine(params, prefill_fn, decode_fn, teng.EngineConfig(max_batch=2),
                               device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(teng.Request(rid=i, prompt=p, max_new=4))
        outs[capture] = [r.out for r in eng.run()]
        if capture:
            assert isinstance(decode_fn, teng.CapturedDecode)
            assert (decode_fn.captures, decode_fn.graphs) == (2, 0)  # B = 2, then B = 1
            steps = 3 * 2 if spec.kind == "lm" else (6 + 3) * 2
            assert decode_fn.replays == steps - 2
    assert outs[True] == outs[False]
