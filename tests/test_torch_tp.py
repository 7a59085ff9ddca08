"""Tensor parallelism in compute (``repro_torch.train.tp``): each layer the
SPMD train step splits over a "model" axis of 2 and of 4 positions, held
against the same layer computed whole on the same weights (the whole
layers are held against the reference's in ``tests/test_torch_layers.py``,
``test_torch_ssm.py`` and the rest).  Float32 on the CPU; the positions
are CPU positions of one group; each param leaf is cut as the train step
cuts it (``PARAM_RULES`` on a (1, M) mesh, the "model" entry of its
spec).  Outputs, and the gradients of a fixed random projection of them,
within 1e-5 x max(1, max |whole|): the split products and the combines
sum in another order.

Also held: two runs of a split step give the same bits; the
reduce-scatter plan of the SPMD step (``sharding.reduce_scatter_plan``)
on a pool of four cards (device objects only, nothing is allocated) sends
every block from the device that summed it straight to the position that
holds it, so no device receives more than its own positions' blocks and
nothing goes through the mesh's first device.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import encdec as TE
from repro_torch.models import layers as L
from repro_torch.models import ssm as TS
from repro_torch.train import sharding as shd
from repro_torch.train import tp as TP
from repro_torch.tree import leaves, tree_map, unflatten

CPU = torch.device("cpu")
TOL = 1e-5
MS = [2, 4]


def close(got, want, tol=TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float((got.double() - want.double()).abs().max()) if want.numel() else 0.0
    assert err <= tol * max(1.0, float(want.abs().max())), err


def init(fn, *args, seed=0):
    """``(params, axes)`` of ``fn(key, *args)``, drawn from a seed."""
    return L.split_tree(fn(L.ParamInit(torch.Generator().manual_seed(seed), CPU), *args))


def cut(params, axes, M):
    """The leaves as a group of ``M`` positions holds them: a leaf the
    rules split over "model" as a ``tp.Split`` of its blocks."""
    mesh = make_mesh(M, model_parallel=M, devices=(CPU,) * M)

    def one(t, ax):
        sh = shd.NamedSharding(mesh, shd._resolve(t.shape, ax, shd.PARAM_RULES, mesh))
        d = shd.model_split_dim(sh)
        if d is None:
            return t
        return TP.Split([t[sh.shard_index((0, m), t.shape)] for m in range(M)], d, t.shape)

    return tree_map(one, params, axes)


def run(fn, params, axes, M, *inputs):
    """``fn(params, *inputs)`` whole and split over ``M`` positions: the
    outputs and the gradients of ``sum(out * r)`` for the float inputs and
    every param, the split ones assembled."""
    results = []
    for m in (None, M):
        flat = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
        xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in inputs]
        p = unflatten(params, flat)
        with TP.use_group(TP.Group([CPU] * m) if m else None):
            out = fn(cut(p, axes, m) if m else p, *xs)
            out = out[0] if isinstance(out, tuple) else out
            r = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
            wrt = flat + [x for x in xs if x.requires_grad]
            grads = torch.autograd.grad((out * r).sum(), wrt, allow_unused=True)
        results.append((out.detach(), [torch.zeros_like(w) if g is None else g
                                       for w, g in zip(wrt, grads)]))
    (want, gw), (got, gg) = results
    close(got, want)
    for a, b in zip(gg, gw):
        close(a, b)
    return got


def randn(*shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def pos(B, S):
    return torch.arange(S, dtype=torch.int32)[None].expand(B, S)


def counting(monkeypatch):
    """Counts each position's entries into ``Group.at``."""
    seen = []
    at = TP.Group.at

    def wrapped(self, m):
        seen.append(m)
        return at(self, m)

    monkeypatch.setattr(TP.Group, "at", wrapped)
    return seen


# -- attention ------------------------------------------------------------------
@pytest.mark.parametrize("M", MS)
def test_attention_split_by_heads(M, monkeypatch):
    """4 query heads, 2 kv heads: on 2 positions both split; on 4 the kv
    heads do not divide, so k and v are computed whole and each position
    reads its query head's."""
    cfg = L.AttnConfig(n_heads=4, n_kv_heads=2, head_dim=8, d_model=16, qkv_bias=True,
                       logit_softcap=30.0)
    params, axes = init(L.init_attention, cfg)
    params = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=torch.Generator()
                                                     .manual_seed(5)), params)
    seen = counting(monkeypatch)
    run(lambda p, x: L.attention(p, x, cfg, pos(2, 6)), params, axes, M, randn(2, 6, 16))
    assert sorted(set(seen)) == list(range(M))
    assert TP.attn_split(4, (2, 6, 4, 8), TP.Group([CPU] * M)) == 2


@pytest.mark.parametrize("M", MS)
def test_attention_seq_sharded(M, monkeypatch):
    """3 heads divide neither 2 nor 4 positions: q, k and v split by
    sequence (8 tokens), the keys gathered, causal masks by position."""
    cfg = L.AttnConfig(n_heads=3, n_kv_heads=3, head_dim=8, d_model=16, window=5)
    params, axes = init(L.init_attention, cfg)
    g = TP.Group([CPU] * M)
    assert TP.attn_split(3, (2, 8, 3, 8), g) == 1
    assert TP.attn_split(3, (2, 7, 3, 8), g) is None  # 7 tokens: computed whole
    seen = counting(monkeypatch)
    run(lambda p, x: L.attention(p, x, cfg, pos(2, 8)), params, axes, M, randn(2, 8, 16))
    assert sorted(set(seen)) == list(range(M))


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("heads", [4, 3])
def test_cross_attention_split(M, heads):
    """The encoder-decoder's cross-attention: by heads (4) or by the
    decoder's and the encoder's sequences (3 heads)."""
    cfg = TE.EncDecConfig(name="t", n_layers=1, d_model=16 if heads == 4 else 12,
                          n_heads=heads, d_ff=16, vocab=64, dtype=torch.float32)
    params, axes = init(TE._init_cross, cfg)
    run(lambda p, x, kv: TE.cross_attention(p, x, kv, cfg)[0], params, axes, M,
        randn(2, 8, cfg.d_model), randn(2, 12, cfg.d_model, seed=2))


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("heads", [4, 6])
def test_mla_split(M, heads):
    """MLA by heads (4 heads on 2 and 4 positions; 6 on 2), by query
    sequence where the heads do not divide (6 on 4)."""
    cfg = L.MLAConfig(d_model=16, n_heads=heads, kv_lora_rank=8, qk_nope_dim=8,
                      qk_rope_dim=4, v_head_dim=8)
    params, axes = init(L.init_mla, cfg)
    run(lambda p, x: L.mla_attention(p, x, cfg, pos(2, 8)), params, axes, M, randn(2, 8, 16))


# -- MLP, MoE -----------------------------------------------------------------------
@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_split_by_columns(M, gated, monkeypatch):
    params, axes = init(L.init_mlp, 16, 24, gated)
    seen = counting(monkeypatch)
    run(lambda p, x: L.mlp(p, x, "gelu"), params, axes, M, randn(2, 5, 16))
    assert sorted(set(seen)) == list(range(M))


@pytest.mark.parametrize("M", MS)
def test_moe_sorted_split_by_experts(M):
    """8 experts over the positions, a shared expert split by columns;
    routing, capacity and the aux loss stay global, with and without the
    whole batch's expert shares (``expert_shares``): the output and the
    aux loss are held, and their gradients."""
    cfg = L.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=8, n_shared=1,
                      capacity_factor=1.0)
    params, axes = init(L.init_moe, cfg)
    x = randn(2, 6, 16)
    run(lambda p, y: L.moe_sorted(p, y, cfg)[0], params, axes, M, x)
    run(lambda p, y: L.moe_sorted(p, y, cfg)[1].reshape(1), params, axes, M, x)

    def shared(p, y):
        key = (p["router"].parts[0] if isinstance(p["router"], TP.Split)
               else p["router"]).data_ptr()
        with L.expert_shares(table={key: torch.arange(8.0) / 28}):
            return L.moe_sorted(p, y, cfg)[1].reshape(1)

    run(shared, params, axes, M, x)


# -- embedding, logits, loss ----------------------------------------------------------
VOCAB = 200  # padded to 256 rows: 56 padded rows on the last position(s)


@pytest.mark.parametrize("M", MS)
def test_embed_split_by_vocab(M, monkeypatch):
    params, axes = init(L.init_embed, VOCAB, 16)
    tokens = torch.randint(0, VOCAB, (2, 9), generator=torch.Generator().manual_seed(4))
    seen = counting(monkeypatch)
    run(lambda p: L.embed(p, tokens, scale=True), params, axes, M)
    assert sorted(set(seen)) == list(range(M))


@pytest.mark.parametrize("M", MS)
def test_unembed_logits_split_by_vocab(M):
    params, axes = init(L.init_embed, VOCAB, 16)
    got = run(lambda p, x: L.unembed_logits(p, x, softcap=30.0, true_vocab=VOCAB), params,
              axes, M, randn(2, 5, 16))
    assert (got[..., VOCAB:] == -1e30).all() and (got[..., :VOCAB] > -1e29).all()


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_softmax_xent_split_by_vocab(M, softcap):
    """Three chunks of 4 over 10 tokens (the last padded), a mask, the
    padded vocabulary rows masked on whichever position holds them, the
    softcap before the max and sum-exp combine."""
    params, axes = init(L.init_embed, VOCAB, 16)
    labels = torch.randint(0, VOCAB, (2, 10), generator=torch.Generator().manual_seed(6))
    mask = (torch.arange(10) % 3 != 1).float()[None].expand(2, 10)
    run(lambda p, x: L.chunked_softmax_xent(p, x, labels, softcap=softcap, chunk=4, mask=mask,
                                            true_vocab=VOCAB).reshape(1),
        params, axes, M, randn(2, 10, 16))


# -- Mamba2 ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", MS)
def test_mamba2_split_by_heads(M, monkeypatch):
    """d_inner 64 in 8 heads of 8, one B/C group of 8: ``w_in``'s 152
    packed columns ``[z 64 | x 64 | B 8 | C 8 | dt 8]`` are stored 76 or
    38 a position, across the z/x (and x/B) boundaries, and ``conv_w``'s
    80 channels 40 or 20 a position; the gated norm (a random scale)
    sums its squares over the positions."""
    cfg = TS.Mamba2Config(d_model=32, d_state=8, headdim=8, chunk=4)
    params, axes = init(TS.init_mamba2, cfg)
    params["norm"]["scale"] = 0.5 * randn(64, seed=9)
    params["a_log"] = 0.3 * randn(8, seed=10)
    params["dt_bias"] = 0.3 * randn(8, seed=11)
    params["conv_b"] = 0.1 * randn(80, seed=12)
    split = cut(params, axes, M)
    assert isinstance(split["w_in"], TP.Split) and split["w_in"].parts[0].shape[-1] == 152 // M
    assert isinstance(split["conv_w"], TP.Split)
    seen = counting(monkeypatch)
    run(lambda p, u: TS.mamba2_forward(p, u, cfg)[0], params, axes, M, randn(2, 10, 32))
    assert sorted(set(seen)) == list(range(M))


def test_mamba2_computes_whole_where_the_heads_do_not_divide():
    """8 heads on 16 positions: the rule drops "model", nothing splits."""
    cfg = TS.Mamba2Config(d_model=32, d_state=8, headdim=8, chunk=4)
    params, axes = init(TS.init_mamba2, cfg)
    g = TP.Group([CPU] * 16)
    assert TP.model_dim((2, 10, 8, 8), ("batch", None, "mamba_heads", None), g) is None
    u = randn(2, 10, 32)
    with TP.use_group(g):
        got = TS.mamba2_forward(params, u, cfg)[0]
    assert torch.equal(got, TS.mamba2_forward(params, u, cfg)[0])


# -- the step -------------------------------------------------------------------------
def test_two_split_steps_give_the_same_bits():
    """Reduced gemma3-4b (heads, kv heads, MLP columns, vocabulary) on a
    (2, 2) mesh, two groups: two runs of two steps agree bit for bit."""
    from test_torch_spmd import host_weights, port_steps

    w = host_weights("gemma3-4b")
    runs = [port_steps(("gemma3-4b", 4, 1, False, 2, None), w,
                       make_mesh(4, model_parallel=2, devices=(CPU,) * 4)) for _ in range(2)]
    (p1, s1, m1), (p2, s2, m2) = runs
    assert m1 == m2
    for a, b in zip(leaves((p1, s1["m"], s1["v"])), leaves((p2, s2["m"], s2["v"]))):
        for pos in shd.positions(a.sharding.mesh):
            assert torch.equal(a.shards[pos], b.shards[pos])


@pytest.mark.parametrize("mesh_kind", ["prod", "2x2"])
def test_reduce_scatter_plan_on_four_cards(mesh_kind):
    """The gradient blocks of every leaf of Mamba2-780M (full width, on
    ``meta``) on the 16x16 mesh at B = 16 (16 groups) and on a (2, 2) mesh
    at B = 4 (2 groups), laid over four cards: each block is summed on the
    device whose position computed it, and each position receives only
    its own shard, from those devices, straight to its own device; the
    mesh's first device receives only for the positions it holds, and
    sends only what its own positions computed."""
    from repro_torch.configs import ARCHS

    pool = [torch.device("cuda", i) for i in range(4)]
    shape, b = ((16, 16), 16) if mesh_kind == "prod" else ((2, 2), 4)
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [pool[i % 4] for i in range(grid.size)]  # as launch/mesh.py lays a pool
    mesh = shd.Mesh(grid.reshape(shape), ("data", "model"))
    params, axes = ARCHS["mamba2-780m"].init(None, device="meta")
    pshard = shd.make_param_sharding(mesh, params, axes)
    kept, G = shd.batch_groups(mesh, b)
    rows = shd.group_positions(mesh, kept)
    devs = [[mesh.devices[p] for p in row] for row in rows]
    first = mesh.devices.flat[0]
    for x, sh in zip(leaves(params), leaves(pshard)):
        sources = shd.grad_sources(sh, x.shape, rows, devs)
        computed = {d for row in devs for d in (row if shd.model_split_dim(sh) is not None
                                                else row[:1])}
        assert {d for _, d in sources} <= computed
        received = dict.fromkeys(pool, 0)
        for position, dst, pieces in shd.reduce_scatter_plan(sh, x.shape, sources):
            assert dst == mesh.devices[position]
            want = shd.region(sh.shard_index(position, x.shape), x.shape)
            for src, reg, sl in pieces:
                assert (reg, src) in sources
                got = tuple((reg[i][0] + s.start, reg[i][0] + s.stop) for i, s in enumerate(sl))
                assert got == want
            assert len(pieces) == len({src for src, _, _ in pieces}) >= 1
            received[dst] += 1
        held = {d: sum(1 for p in shd.positions(mesh) if mesh.devices[p] == d) for d in pool}
        assert received == held
        assert all(src != first or any(first == d for row in devs for d in row)
                   for src, _ in sources)


def test_group_positions_follow_the_model_axis():
    mesh = make_production_mesh(multi_pod=True, devices=(CPU,))
    rows = shd.group_positions(mesh, ("pod",))
    assert len(rows) == 2 and rows[1][:2] == [(1, 0, 0), (1, 0, 1)] and len(rows[1]) == 16
    rows = shd.group_positions(mesh, ("pod", "data"))
    assert len(rows) == 32 and rows[17][3] == (1, 1, 3)


def test_describe_names_each_family_split():
    from repro_torch.configs import ARCHS

    assert "mamba heads 3 a position" in TP.describe(ARCHS["mamba2-780m"])
    assert "seq_sharded (12 heads on 16;" in TP.describe(ARCHS["whisper-small"])
    assert "experts 4 a position" in TP.describe(ARCHS["olmoe-1b-7b"])


def test_split_unbinds_layers():
    t = torch.arange(24.0).reshape(2, 3, 4)
    s = TP.Split([t[..., :2], t[..., 2:]], 2)
    layers = s.unbind()
    assert len(layers) == 2 and layers[1].dim == 1 and tuple(layers[1].shape) == (3, 4)
    assert torch.equal(TP.whole(layers[1]), t[1])
    assert np.array_equal(TP.shares(12, 4), [(0, 3), (3, 6), (6, 9), (9, 12)])


def test_moe_groups_on_a_data_only_mesh():
    """Reduced OLMoE in two data groups on a (2, 1) mesh (each group whole,
    its aux with the whole batch's expert shares) and on the (2, 2) mesh
    (each group split over two positions): the same step within 1e-5."""
    from test_torch_spmd import host_weights, port_steps

    w = host_weights("olmoe-1b-7b")
    whole = port_steps(("olmoe-1b-7b", 4, 1, False, 1, None), w,
                       make_mesh(2, model_parallel=1, devices=(CPU,) * 2))
    split = port_steps(("olmoe-1b-7b", 4, 1, False, 2, None), w,
                       make_mesh(4, model_parallel=2, devices=(CPU,) * 4))
    for a, b in zip(whole[2], split[2]):
        assert all(abs(a[n] - b[n]) <= TOL * abs(a[n]) for n in ("loss", "grad_norm"))
    for x, y in zip(leaves(whole[0]), leaves(split[0])):
        close(shd.gather(y, CPU), shd.gather(x, CPU))
