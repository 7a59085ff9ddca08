"""Architecture registry machinery.

Port of ``src/repro/configs/common.py``.  Each ``configs/<arch>.py``
exports ``spec: ArchSpec``, which binds a model family (``lm``,
``mamba_lm``, ``hybrid``, ``encdec``) to its full-size config, a reduced
same-family config for small runs, and the input shapes that apply.
Every family inits, computes its loss, trains (``make_train_step``: one
eager step of autograd and Adam, with gradient accumulation over
microbatches, run SPMD over a mesh when the params are placed on one) and
makes its prefill and decode steps.  Abstract trees
(``make_abstract``, ``abstract_opt_state``, ``bf16_params``) are tensors on
the ``meta`` device, and so are ``input_specs`` (a shape's batch) and
``state_specs`` (the decode-time state and its logical axes), which the
dry run (``launch/dryrun.py``) shards and counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.optim.adam import AdamConfig, adam_update
from repro_torch.train import sharding as shd
from repro_torch.train import tp as TP
from repro_torch.tree import leaves, tree_map, unflatten

#: Each family's module under ``repro_torch.models`` and its init, loss
#: and decode functions there.
_FAMILIES = {
    "lm": ("transformer", "init_lm", "train_loss", "decode_step"),
    "mamba_lm": ("ssm", "init_mamba2_lm", "mamba2_lm_loss", "mamba2_lm_decode"),
    "hybrid": ("hybrid", "init_hybrid", "train_loss", "decode_step"),
    "encdec": ("encdec", "init_encdec", "train_loss", "decode_step"),
}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    kind: str  # "lm" | "mamba_lm" | "hybrid" | "encdec" | "gnn"
    config: Any
    reduced: Any
    shapes: tuple = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: str = ""
    uses_paper_technique: bool = False  # SCV-sorted MoE dispatch
    train_microbatch: int = 1  # grad-accumulation splits (activation memory)
    master_weights: bool = False  # bf16 params + f32 master in opt state

    def cfg(self, reduced=False):
        return self.reduced if reduced else self.config

    # -- family dispatch ---------------------------------------------------
    def _entry(self, role: str) -> Callable:
        """The family's ``init``, ``loss`` or ``decode`` function."""
        if self.kind not in _FAMILIES:
            raise ValueError(self.kind)
        module, *names = _FAMILIES[self.kind]
        mod = importlib.import_module(f"repro_torch.models.{module}")
        return getattr(mod, names[("init", "loss", "decode").index(role)])

    def init(self, generator, reduced=False, device="cuda"):
        """(params, specs) on ``device`` (default the card; raises
        without one), drawn from ``generator``."""
        return self._entry("init")(generator, self.cfg(reduced), device=device)

    def loss_fn(self, reduced=False) -> Callable:
        train_loss = self._entry("loss")
        cfg = self.cfg(reduced)
        return lambda p, batch: train_loss(p, cfg, batch)

    def make_train_step(self, adam_cfg: AdamConfig | None = None, reduced=False,
                        microbatch: int | None = None, gather_params_once: bool | None = None):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        metrics)``: the loss and its gradients by autograd (activations
        recomputed where the reference checkpoints them, ``layers.remat``),
        then one ``adam_update``.  With ``microbatch = k > 1`` the batch is
        split into ``k`` slices along its first axis, run one after another
        (activation memory scales 1/k), and the gradients ``g / k`` and the
        loss ``l / k`` accumulate in float32, in the reference's order.
        The step runs eagerly on the params' device.

        When the params and the Adam state are placed on a mesh
        (``train.sharding.Sharded`` leaves), the step runs SPMD over it
        (:func:`spmd_step`); ``gather_params_once`` then gathers the
        params whole once a step, before the microbatches (as the
        reference hoists its ``unfsdp_params`` before its scan), not once
        a microbatch."""
        adam_cfg = adam_cfg or AdamConfig()
        loss_fn = self.loss_fn(reduced)
        k = microbatch if microbatch is not None else (1 if reduced else self.train_microbatch)
        moe = getattr(self.cfg(reduced), "moe", None) is not None

        def value_and_grad(params, batch):
            lv = leaves(params)  # a ``tp.Split`` leaf differentiates by its parts
            flat = [t.detach().requires_grad_(True) for t in TP.flatten(lv)]
            with torch.enable_grad():
                loss = loss_fn(unflatten(params, TP.rebuild(lv, flat)), batch)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)]
            return loss.detach(), unflatten(params, TP.rebuild(lv, grads))

        def train_step(params, opt_state, batch):
            if isinstance(leaves(params)[0], shd.Sharded):
                return spmd_step(adam_cfg, value_and_grad, loss_fn if moe else None, k,
                                 bool(gather_params_once), params, opt_state, batch)
            if k == 1:
                loss, grads = value_and_grad(params, batch)
            else:
                dev = leaves(params)[0].device
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
                for i in range(k):
                    mb = {name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
                          for name, x in batch.items()}
                    l, g = value_and_grad(params, mb)
                    grads = tree_map(lambda a, gg: a + gg.to(torch.float32) / k, grads, g)
                    loss = loss + l / k
            params, opt_state, metrics = adam_update(adam_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, **metrics}

        return train_step

    def make_prefill_step(self, shape: Shape, reduced=False):
        cfg = self.cfg(reduced)
        S = shape.seq_len if not reduced else min(shape.seq_len, 64)
        if self.kind == "lm":
            from repro_torch.models.transformer import prefill

            def step(params, batch):
                return prefill(params, cfg, batch["tokens"],
                               extra_embed=batch.get("extra_embed"), max_len=S)

        elif self.kind in ("mamba_lm", "hybrid"):
            from repro_torch.models.layers import unembed_logits

            if self.kind == "mamba_lm":
                from repro_torch.models.ssm import mamba2_lm_hidden as hidden
            else:
                from repro_torch.models.hybrid import hidden_states as hidden

            def step(params, batch):
                x, _ = hidden(params, cfg, batch["tokens"])
                return unembed_logits(params["embed"], x[:, -1:], true_vocab=cfg.vocab)

        elif self.kind == "encdec":
            from repro_torch.models.encdec import encode, init_dec_cache

            def step(params, batch):
                enc = encode(params, cfg, batch["frames"])
                return init_dec_cache(params, cfg, enc, max_len=8)

        else:
            raise ValueError(self.kind)
        return step

    def make_decode_step(self, shape: Shape, reduced=False):
        decode_step = self._entry("decode")
        cfg = self.cfg(reduced)

        def step(params, state, batch):
            return decode_step(params, cfg, batch["token"], state, batch["pos"])

        return step

    # -- abstract inputs, on the meta device ----------------------------------
    def input_specs(self, shape_name: str, reduced=False) -> dict:
        """The batch for ``shape_name`` as tensors on ``meta``: the
        reference's ``ShapeDtypeStruct`` keys, shapes and dtypes."""
        shape = SHAPES[shape_name]
        cfg = self.cfg(reduced)
        B = shape.global_batch if not reduced else 2
        S = shape.seq_len if not reduced else min(shape.seq_len, 64)
        i32, f32 = torch.int32, torch.float32
        d = getattr(cfg, "d_model")

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"token": meta((B, 1), i32), "pos": meta((B, 1), i32)}
        extra = 1 if shape.kind == "train" else 0  # the shifted target
        if self.kind == "encdec":
            batch = {"frames": meta((B, S, d), f32)}
            if extra:
                batch["tokens"] = meta((B, S + 1), i32)
            return batch
        nfront = getattr(cfg, "n_frontend_tokens", 0)
        batch = {"tokens": meta((B, S - nfront + extra), i32)}
        if nfront:
            batch["extra_embed"] = meta((B, nfront, d), f32)
        return batch

    def state_specs(self, shape_name: str, reduced=False):
        """``(shape tree on meta, axes tree)`` of the decode-time state."""
        shape = SHAPES[shape_name]
        cfg = self.cfg(reduced)
        B = shape.global_batch if not reduced else 2
        S = shape.seq_len if not reduced else min(shape.seq_len, 64)
        if self.kind == "lm":
            from repro_torch.models.transformer import cache_specs, init_cache

            return init_cache(cfg, B, S, device="meta"), cache_specs(cfg)
        if self.kind == "mamba_lm":
            from repro_torch.models.ssm import init_mamba2_lm_state, mamba2_lm_state_specs

            return init_mamba2_lm_state(cfg, B, device="meta"), mamba2_lm_state_specs(cfg)
        if self.kind == "hybrid":
            from repro_torch.models.hybrid import init_state, state_specs

            return init_state(cfg, B, S, device="meta"), state_specs(cfg)
        if self.kind == "encdec":
            from repro_torch.models.encdec import cache_specs as ed_specs

            L_, H, D = cfg.n_layers, cfg.n_heads, cfg.head_dim
            kv = torch.empty((L_, B, S, H, D), dtype=cfg.dtype, device="meta")
            shapes = {
                "k": kv, "v": kv.clone(),
                "pos": torch.empty((L_, S), dtype=torch.int32, device="meta"),
                "len": torch.empty((L_,), dtype=torch.int32, device="meta"),
                "xk": kv.clone(), "xv": kv.clone(),
            }
            return shapes, ed_specs(cfg)
        raise ValueError(self.kind)

    # -- counts, from shapes alone -------------------------------------------
    def _meta_params(self, reduced):
        return self.init(None, reduced, device="meta")[0]

    def param_count(self, reduced=False) -> int:
        from repro_torch.models.transformer import leaf_paths

        return sum(int(np.prod(t.shape)) for _, t in leaf_paths(self._meta_params(reduced)))

    def active_param_count(self, reduced=False) -> int:
        from repro_torch.models.transformer import leaf_paths

        moe = getattr(self.cfg(reduced), "moe", None)
        total = 0
        for keys, t in leaf_paths(self._meta_params(reduced)):
            n = int(np.prod(t.shape))
            if moe is not None and "moe" in keys and (
                keys.endswith("wi") or keys.endswith("wg") or keys.endswith("wo")
            ):
                n = n * moe.top_k // moe.n_experts
            total += n
        return total


# -- the SPMD step over a mesh --------------------------------------------------
def _global_shares(loss_fn, trees, slices, groups, homes) -> list:
    """For each data group, (layer key -> expert shares of the whole
    microbatch), on the group's first device (``homes``): each group's
    slot counts from a forward without gradients
    (``layers.expert_shares``), summed over the groups in order."""
    records = []
    with torch.no_grad():
        for tree, gb, grp in zip(trees, slices, groups):
            rec = []
            with L.expert_shares(record=rec), TP.use_group(grp):
                loss_fn(tree, gb)
            records.append(rec)
    if not records[0]:  # no sorted dispatch: the groups keep their own shares
        return []
    slots = sum(r[0][2] for r in records)
    shares = [sum(r[i][1].to(homes[0]) for r in records) / slots
              for i in range(len(records[0]))]
    return [{key: s.to(home) for (key, _, _), s in zip(rec, shares)}
            for rec, home in zip(records, homes)]


def spmd_step(adam_cfg, value_and_grad, moe_loss_fn, k, once, params, opt_state, batch):
    """One train step SPMD over the mesh the params are placed on.

    Each of the ``k`` microbatches is split over the data groups, the mesh
    axes the reference keeps for its batch dim (``sharding.batch_groups``).
    A group computes over its positions along "model"
    (``sharding.group_positions``) with the blocks of each param that
    those positions hold once the batch axes' factor is gathered
    (``sharding.compute_sharding``, the reference's ``unfsdp_params``): a
    leaf split over "model" as a ``tp.Split`` of the positions' blocks, a
    leaf held whole as one tensor; with a "model" axis of one, whole
    leaves on the group's device (``sharding.group_devices``), and the
    model code computes whole.  The blocks are gathered at each
    microbatch, or once a step with ``once``; positions on one device
    share them.  Under a "model" axis of ``M > 1`` the model code splits
    each product the reference constrains over the positions
    (``train/tp.py``).

    Each device sums the gradient blocks of the groups it runs, scaled by
    ``1 / (k G)``, group by group within a microbatch and microbatch by
    microbatch (the unplaced step's order with ``k G`` microbatches; with
    one group and one microbatch the gradients are taken as they come).
    ``grad_norm`` is a fixed-order sum of squared norms: of each model
    position's blocks in position order and leaf order when one device
    holds every sum (with one position, ``global_norm`` of the whole
    gradients), else of each position's reduced shard.  The sums are then
    reduce-scattered to every position's shard by
    ``sharding.reduce_scatter_plan`` (peer copies from the device that
    summed a block to the position's device, summed in source order), and
    ``adam_update`` runs on each position's shards of the params and the
    moments.  ``moe_loss_fn``, the loss of an arch with sorted MoE
    dispatch, gives every group the whole microbatch's expert shares in
    its aux loss (:func:`_global_shares`).  Returns placed params and
    state, and the whole batch's ``loss``, ``grad_norm`` and ``lr``."""
    flat = leaves(params)
    mesh = flat[0].sharding.mesh
    b = next(iter(batch.values())).shape[0] // k
    kept, G = shd.batch_groups(mesh, b)
    M = mesh.shape.get("model", 1)
    rows = shd.group_positions(mesh, kept)
    if M == 1:
        row_devs = [[d] for d in shd.group_devices(mesh.devices, mesh.axis_names, kept)]
    else:
        row_devs = [[mesh.devices[pos] for pos in row] for row in rows]
    groups = [TP.Group(devs) if M > 1 else None for devs in row_devs]
    views = [shd.compute_sharding(x.sharding) for x in flat]
    splits = [shd.model_split_dim(x.sharding) for x in flat]
    n, per = k * G, b // G

    def group_trees():
        """Each group's leaves: a block a (device, leaf, region) built once."""
        cache, trees = {}, []
        for row, devs in zip(rows, row_devs):
            out = []
            for j, x in enumerate(flat):
                blocks = []
                for m in range(len(row) if splits[j] is not None else 1):
                    index = views[j].shard_index(row[m], x.shape)
                    key = (devs[m], j, shd.region(index, x.shape))
                    if key not in cache:
                        cache[key] = shd.gather_block(x, index, devs[m])
                    blocks.append(cache[key])
                out.append(TP.Split(blocks, splits[j], x.shape) if splits[j] is not None
                           else blocks[0])
            trees.append(unflatten(params, out))
        return trees

    kept_trees = group_trees() if once else None
    loss = None
    acc = [{} for _ in flat]  # leaf -> {(region, device): summed gradient block}
    home = row_devs[0][0]
    for i in range(k):
        mb = batch if k == 1 else {name: x.reshape((k, b) + tuple(x.shape[1:]))[i]
                                   for name, x in batch.items()}
        trees = kept_trees if once else group_trees()
        slices = [mb] if G == 1 else [
            {name: x[g * per:(g + 1) * per].to(row_devs[g][0]) for name, x in mb.items()}
            for g in range(G)]
        tables = _global_shares(moe_loss_fn, trees, slices, groups, [d[0] for d in row_devs]) \
            if moe_loss_fn is not None and G > 1 else []
        for g in range(G):
            with L.expert_shares(table=tables[g]) if tables else contextlib.nullcontext(), \
                    TP.use_group(groups[g]):
                l, gr = value_and_grad(trees[g], slices[g])
            for j, x in enumerate(leaves(gr)):
                blocks = x.parts if isinstance(x, TP.Split) else [x]
                for m, t in enumerate(blocks):
                    key = (shd.region(views[j].shard_index(rows[g][m], flat[j].shape),
                                      flat[j].shape), row_devs[g][m])
                    if n == 1:
                        acc[j][key] = t
                    elif key not in acc[j]:
                        acc[j][key] = torch.zeros(t.shape, dtype=torch.float32,
                                                  device=t.device).add_(t.to(torch.float32) / n)
                    else:
                        acc[j][key].add_(t.to(torch.float32) / n)
            if n == 1:
                loss = l
            else:
                if loss is None:
                    loss = torch.zeros((), dtype=torch.float32, device=home)
                loss = loss + l.to(home) / n
            del gr
        del trees
    del kept_trees

    plans = [shd.reduce_scatter_plan(x.sharding, x.shape, shd.grad_sources(
        x.sharding, x.shape, rows, row_devs)) for x in flat]
    one_device = len({dev for a in acc for _, dev in a}) == 1
    scattered = []
    for x, a, plan in zip(flat, acc, plans):
        shards = np.empty(mesh.devices.shape, dtype=object)
        for pos, dev, pieces in plan:
            (src_dev, reg, sl), *rest = pieces
            out = torch.empty(tuple(s.stop - s.start for s in sl), dtype=a[(reg, src_dev)].dtype,
                              device=dev).copy_(a[(reg, src_dev)][sl])
            for src_dev, reg, sl in rest:
                out.add_(a[(reg, src_dev)][sl].to(dev))
            shards[pos] = out
        scattered.append(shd.Sharded(x.shape, out.dtype, x.sharding, shards))
    if one_device:  # each model position's blocks, leaf by leaf
        pieces = [a[(shd.region(v.shard_index(rows[0][m], x.shape), x.shape), home)]
                  for m in range(M) for x, a, v, sp in zip(flat, acc, views, splits)
                  if sp is not None or m == 0]
    else:  # each distinct shard once, position by position
        seen, pieces = set(), []
        for pos in shd.positions(mesh):
            for j, x in enumerate(flat):
                key = (j, shd.region(x.sharding.shard_index(pos, x.shape), x.shape))
                if key not in seen:
                    seen.add(key)
                    pieces.append(scattered[j].shards[pos])
    total = None  # global_norm's sum, each square summed where its piece lies
    for t in pieces:
        sq = torch.sum(torch.square(t.to(torch.float32))).to(home)
        total = sq if total is None else total + sq
    gnorm = torch.sqrt(total)
    del acc

    keys = [key for key in ("m", "v", "master") if key in opt_state]
    state = {key: leaves(opt_state[key]) for key in keys}
    out = {key: [np.empty(mesh.devices.shape, dtype=object) for _ in flat]
           for key in ["params"] + keys}
    step = np.empty(mesh.devices.shape, dtype=object)
    norms, lr = {}, None

    def at(xs, pos):
        return unflatten(params, [x.shards[pos] for x in xs])

    for pos in shd.positions(mesh):
        dev = mesh.devices[pos]
        if dev not in norms:
            norms[dev] = gnorm.to(dev)
        st = {key: at(state[key], pos) for key in keys}
        st["step"] = opt_state["step"].shards[pos]
        new_p, new_st, metrics = adam_update(adam_cfg, at(flat, pos), at(scattered, pos), st,
                                             gnorm=norms[dev])
        lr = metrics["lr"] if lr is None else lr
        for key, tree in [("params", new_p)] + [(key, new_st[key]) for key in keys]:
            for j, t in enumerate(leaves(tree)):
                out[key][j][pos] = t
        step[pos] = new_st["step"]

    def placed(like, key):
        return unflatten(params, [shd.Sharded(x.shape, x.dtype, x.sharding, s)
                                  for x, s in zip(like, out[key])])

    new_state = {key: placed(state[key], key) for key in keys}
    old_step = opt_state["step"]
    new_state["step"] = shd.Sharded(old_step.shape, old_step.dtype, old_step.sharding, step)
    return placed(flat, "params"), new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


# -- abstract trees, on the meta device ---------------------------------------
def make_abstract(tree):
    """The tree's shapes and dtypes as tensors on ``meta`` (no memory)."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype, device="meta"), tree)


def abstract_opt_state(params_shapes, master_weights: bool = False):
    """``init_adam``'s state for ``params_shapes``, on ``meta``."""

    def f32(x):
        return torch.empty(tuple(x.shape), dtype=torch.float32, device="meta")

    st = {
        "m": tree_map(f32, params_shapes),
        "v": tree_map(f32, params_shapes),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }
    if master_weights:
        st["master"] = tree_map(f32, params_shapes)
    return st


def bf16_params(params_shapes):
    """The bf16 compute-param tree (``master_weights`` mode), on ``meta``."""
    return tree_map(
        lambda x: torch.empty(tuple(x.shape), device="meta",
                              dtype=torch.bfloat16 if x.dtype == torch.float32 else x.dtype),
        params_shapes,
    )
