"""Plan executor: where SCV plans meet a pool of devices.

Port of ``src/repro/core/exec.py``.  The paper's scalability argument
(§V-G: equal-nnz Z-Morton spans keep each device's traffic local; the
block-rows that spans share merge cheaply) and the feature axis beside it
compose as one ``(tile_parts, feature_parts)`` grid of devices:

* ``"tiles"`` — the Z-ordered tile sequence of each capacity segment is
  cut into equal-nnz spans (``core.partition``), one span per grid row;
  the spans' partial outputs are summed once, on the output device.
* ``"features"`` — grid column q aggregates the feature slab
  ``Z[:, f0:f1]``; the slabs' outputs are disjoint columns, concatenated.

The reference runs the grid as one ``shard_map`` over a JAX mesh and
merges with one ``psum``.  The port keeps its single controller: one
process holds the pool (a tuple of ``torch.device``), launches every
span's chain on its device, and sums the partials on ``devices[0]`` in
span order — the counterpart of the ``psum``, deterministic and
bit-exact on integer inputs.  A pool may name one card more than once,
as the reference's tests name one host eight times; its spans then run
one after another on that card's stream.

* :class:`ShardingDecision` — kind and axis sizes; hashable, and part of
  the serving engine's composite cache key (``signature``).
* :class:`ShardedPlan` — per capacity segment, one port ``SCVPlan`` per
  span (its leaves, its own ``RunIndex``), on its grid row's devices.
* :class:`PlanExecutor` — the pool, the decision rule
  (:func:`decide_sharding`), placement (``prepare``) and execution
  (``aggregate``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.partition import nnz_imbalance, partition_of, shard_plan
from repro_torch.core.scv import RunIndex, SCVBucketedPlan, SCVPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan

#: Grid axis names (the reference's mesh axes).
TILE_AXIS = "tiles"
FEATURE_AXIS = "features"

#: Decision-rule floors, the reference's values, so that decisions agree:
#: an axis is split only while each part keeps at least this much work.
MIN_NNZ_PER_PART = 4096
#: The reference's floor is one TPU feature block (128 lanes), below which
#: its kernel pads a slab back to 128 columns.  The port's kernel masks any
#: width; the floor stays for parity of decisions until the card's own is
#: measured (ROADMAP.md).
MIN_FEATURES_PER_PART = 128
#: Output-row estimate when the caller knows only nnz: the SCV regime is
#: power-law graphs of average degree about 8 (paper §V).
EST_AVG_DEGREE = 8


# ---------------------------------------------------------------------------
# the sharding decision
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardingDecision:
    """How a plan meets the device grid.  Hashable; ``signature`` salts the
    serving engine's composite keys."""

    kind: str  # "replicated" | "tiles" | "features" | "2d"
    tile_parts: int = 1
    feature_parts: int = 1

    def __post_init__(self):
        kinds = ("replicated", "tiles", "features", "2d")
        if self.kind not in kinds:
            raise ValueError(f"kind must be one of {kinds}, got {self.kind!r}")
        if self.tile_parts < 1 or self.feature_parts < 1:
            raise ValueError("axis sizes must be >= 1")
        tp, fp = self.tile_parts, self.feature_parts
        ok = {
            "replicated": (tp, fp) == (1, 1),
            "tiles": fp == 1,  # tp == 1 allowed: a degenerate 1-span placement
            "features": tp == 1,
            "2d": tp > 1 and fp > 1,
        }[self.kind]
        if not ok:
            raise ValueError(
                f"kind {self.kind!r} inconsistent with axes "
                f"(tile_parts={tp}, feature_parts={fp})"
            )

    @property
    def n_devices(self) -> int:
        return self.tile_parts * self.feature_parts

    @property
    def signature(self) -> str:
        """Stable string for cache-key salts."""
        return f"{self.kind}:t{self.tile_parts}f{self.feature_parts}"


def placement_bytes(
    nnz: int,
    n_features: int,
    tile_parts: int,
    feature_parts: int,
    *,
    n_rows: Optional[int] = None,
    machine=None,
    n_slots: Optional[int] = None,
) -> dict:
    """Per-device byte model of a ``(tile_parts, feature_parts)`` placement,
    the reference's (``simul.machine.MachineConfig`` gives the element width
    and the DRAM rate).

    Resident: ``plan`` (the span's rows, cols and vals: ``3 * nnz * B / tp``,
    or the launched slots when ``n_slots`` is given), ``z_slab`` and ``out``
    (split by the feature axis).  Traffic: ``z_gather`` (one Z row per
    entry, ``(nnz / tp) * (F / fp) * B``) and ``collective`` (a ring
    all-reduce of the out slab over the tile axis, ``2 (tp - 1) / tp`` of
    it; zero at ``tp == 1``).  ``resident`` sums plan, z_slab and out;
    ``total`` (what :func:`decide_sharding` minimises) plan, z_gather, out
    and collective; ``est_seconds`` is total over ``dram_gbps``.
    ``n_rows`` defaults to ``nnz // EST_AVG_DEGREE``.  The model prices the
    merge's card-to-card bytes like device-memory bytes: a TPU-derived
    assumption not yet measured on the port's cards (ROADMAP.md).
    """
    if machine is None:
        from repro_torch.simul.machine import MachineConfig

        machine = MachineConfig()
    b = machine.bytes_per_elem
    rows = max(int(n_rows) if n_rows is not None else nnz // EST_AVG_DEGREE, 1)
    tp, fp = tile_parts, feature_parts
    if n_slots is None:
        plan = 3 * nnz * b / tp
    else:
        from repro_torch.tune.cost import plan_slot_bytes

        plan = plan_slot_bytes(n_slots, machine) / tp
    z_slab = rows * n_features * b / fp
    out = rows * n_features * b / fp
    z_gather = (nnz / tp) * (n_features / fp) * b
    collective = 2 * (tp - 1) / tp * out
    total = plan + z_gather + out + collective
    return {
        "plan": plan,
        "z_slab": z_slab,
        "out": out,
        "z_gather": z_gather,
        "collective": collective,
        "resident": plan + z_slab + out,
        "total": total,
        "est_seconds": total * 8 / (machine.dram_gbps * 1e9),
    }


def decide_sharding(
    nnz: int,
    n_features: int,
    n_devices: int,
    *,
    n_rows: Optional[int] = None,
    machine=None,
    min_nnz_per_part: int = MIN_NNZ_PER_PART,
    min_features_per_part: int = MIN_FEATURES_PER_PART,
    n_slots: Optional[int] = None,
) -> ShardingDecision:
    """The reference's rule: among power-of-two ``(tp, fp)`` with ``tp * fp
    <= n_devices`` that keep ``min_nnz_per_part`` entries per span and
    ``min_features_per_part`` columns per slab, the least
    :func:`placement_bytes` total wins; ties go to more tile spans, then to
    fewer devices."""
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    tps = [1]
    while tps[-1] * 2 <= n_devices and nnz // (tps[-1] * 2) >= min_nnz_per_part:
        tps.append(tps[-1] * 2)
    fps = [1]
    while (
        fps[-1] * 2 <= n_devices
        and n_features // (fps[-1] * 2) >= min_features_per_part
    ):
        fps.append(fps[-1] * 2)
    best = None
    for tp in tps:
        for fp in fps:
            if tp * fp > n_devices:
                continue
            cost = placement_bytes(
                nnz, n_features, tp, fp,
                n_rows=n_rows, machine=machine, n_slots=n_slots,
            )["total"]
            key = (cost, -tp, tp * fp)
            if best is None or key < best[0]:
                best = (key, tp, fp)
    _, tp, fp = best
    kind = (
        "replicated" if (tp, fp) == (1, 1)
        else "tiles" if fp == 1
        else "features" if tp == 1
        else "2d"
    )
    return ShardingDecision(kind=kind, tile_parts=tp, feature_parts=fp)


# ---------------------------------------------------------------------------
# the placed plan
# ---------------------------------------------------------------------------
_LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """A plan placed on a device grid.

    ``segments[j][p]`` is span p of capacity segment j: a port ``SCVPlan``
    holding the span's leaves (``[span_width, ...]``; padded slots are
    zero-nnz tiles repeating the span's last real tile, perm ``-1``) and
    its own ``RunIndex``, on ``devices[p][0]``.  ``devices`` is the
    ``[tile_parts][feature_parts]`` grid; ``devices[0][0]`` holds Z and the
    output.  Grid cells of row p on another device get their copy of the
    span at first use (:meth:`span`), kept with the plan."""

    segments: tuple[tuple[SCVPlan, ...], ...]
    devices: tuple[tuple[torch.device, ...], ...]
    decision: ShardingDecision
    # (p, q) -> span p's launch plan on devices[p][q] (None: no entry)
    _placed: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    # -- the reference's aux, read from the spans --------------------------
    @property
    def _first(self) -> SCVPlan:
        return next(s for spans in self.segments for s in spans)

    @property
    def tile(self) -> int:
        return self._first.tile

    @property
    def shape(self) -> tuple[int, int]:
        return self._first.shape

    @property
    def order(self) -> str:
        return self._first.order

    @property
    def caps(self) -> tuple[int, ...]:
        return tuple(spans[0].cap for spans in self.segments)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return self._first.padded_shape

    @property
    def n_parts(self) -> int:
        return self.decision.tile_parts

    @property
    def device(self) -> torch.device:
        """The output device: Z and the aggregation's result live here."""
        return self.devices[0][0]

    @property
    def perm(self):
        """Whether every span carries perm (per-edge re-weighting works);
        for feature tests, not for indexing."""
        perms = [s.perm for spans in self.segments for s in spans]
        return None if any(p is None for p in perms) else perms

    def reweighted(self, edge_vals: torch.Tensor) -> "ShardedPlan":
        """Per-edge re-weighting (GAT): each span's perm indexes the global
        edge array (spans gather tiles, not entries), padded slots carry
        ``-1`` and pull the appended zero."""
        return dataclasses.replace(self, segments=tuple(
            tuple(s.reweighted(edge_vals.to(s.device)) for s in spans)
            for spans in self.segments
        ))

    def span(self, p: int, q: int = 0) -> Union[SCVPlan, SCVBucketedPlan, None]:
        """Span p's chain on ``devices[p][q]``: its segments that hold an
        entry (one chain, one launch of the vector body), or ``None`` when
        none does."""
        if (p, q) not in self._placed:
            dev = self.devices[p][q]
            live = tuple(
                s if s.device == dev else s.to(dev)
                for s in (spans[p] for spans in self.segments)
                if s.runs.max_nnz > 0
            )
            self._placed[(p, q)] = (
                None if not live else live[0] if len(live) == 1 else SCVBucketedPlan(live)
            )
        return self._placed[(p, q)]

    # -- host-side introspection --------------------------------------------
    def _segment_nnz_per_part(self, spans) -> np.ndarray:
        return np.array([int(s.nnz_in_tile.sum()) for s in spans], np.int64)

    def nnz_per_part(self) -> np.ndarray:
        """int64[tile_parts]: nonzeros per span, summed over segments."""
        return sum(
            (self._segment_nnz_per_part(spans) for spans in self.segments),
            np.zeros(self.decision.tile_parts, np.int64),
        )

    @property
    def imbalance(self) -> float:
        """max/mean nnz over the tile spans (1.0: perfect balance)."""
        return nnz_imbalance(self.nnz_per_part())

    @property
    def imbalance_per_segment(self) -> tuple[float, ...]:
        return tuple(
            nnz_imbalance(self._segment_nnz_per_part(spans)) for spans in self.segments
        )

    def stacked(self) -> tuple[dict, ...]:
        """Host copies of the leaves as the reference stacks them: per
        segment, ``{leaf: array[tile_parts, span_width, ...]}`` (``perm``
        is ``None`` where the plan has none)."""
        out = []
        for spans in self.segments:
            out.append({
                k: None if getattr(spans[0], k) is None
                else np.stack([getattr(s, k).detach().cpu().numpy() for s in spans])
                for k in _LEAVES
            })
        return tuple(out)


# ---------------------------------------------------------------------------
# the sharded aggregation
# ---------------------------------------------------------------------------
def merge_partials(parts: list[torch.Tensor], device, shape) -> torch.Tensor:
    """Sum span partials on ``device`` in span order (the reference's one
    ``psum`` over the tile axis); zeros of ``shape`` when no span holds an
    entry."""
    if not parts:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out


def aggregate_sharded(sp: ShardedPlan, z: torch.Tensor) -> torch.Tensor:
    """out = Â Z over a placed plan; returns ``[n_rows, F]`` on
    ``sp.device``, as ``aggregate_scv_plan`` does.

    Grid cell (p, q) runs span p's chain over feature slab q on its device:
    one kernel launch over the span's segments that hold an entry, from an
    explicit zero output (``scv_spmm_plan(init="zeros")``), so a span owes
    no coverage and rows it does not visit stay zero.  Slab q is
    ``z[:, f0:f1]`` with ``f1 - f0 = ceil(F / fp)`` (the last narrower;
    where F < fp the last slabs are empty, and an empty slab launches
    nothing), made contiguous once per device; the kernel masks any width,
    so Z is not padded.  Each slab's partials are summed on the output
    device in span order (:func:`merge_partials`) and the slabs
    concatenated.
    Differentiable in ``z`` and in the spans' values, through each chain's
    autograd Function and the copies and sums."""
    tp, fp = sp.decision.tile_parts, sp.decision.feature_parts
    n_feat = z.shape[1]
    width = -(-n_feat // fp)
    n_rows_p = sp.padded_shape[0]
    cols = []
    for q in range(fp):
        f0, f1 = min(n_feat, q * width), min(n_feat, (q + 1) * width)
        slabs, parts = {}, []
        for p in range(tp):
            plan = sp.span(p, q)
            if plan is None:
                continue
            dev = sp.devices[p][q]
            if dev not in slabs:
                slabs[dev] = z[:, f0:f1].to(dev).contiguous()
            parts.append(scv_spmm_plan(plan, slabs[dev], init="zeros"))
        cols.append(merge_partials(parts, sp.device, (n_rows_p, f1 - f0)))
    out = cols[0] if fp == 1 else torch.cat(cols, dim=1)
    return out[: sp.shape[0]]


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
def cuda_pool() -> tuple[torch.device, ...]:
    """Every CUDA card, ``cuda:0`` first; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the executor's default pool is every CUDA card and none is "
            "available; pass devices=(torch.device('cpu'),) * n for the plain "
            "PyTorch path"
        )
    return tuple(torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count()))


def pool_device(d) -> torch.device:
    """``d`` as a pool entry: resolved (raises when absent), a CUDA device
    with its index, so that entries naming one card compare equal."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class PlanExecutor:
    """Owns the placement of SCV plans on a pool of devices.

    ``devices`` defaults to every CUDA card (:func:`cuda_pool`) and may name
    a card more than once; each entry must be present, or construction
    raises.  ``decide`` picks a grid over a prefix of the pool, ``prepare``
    places a plan, ``aggregate`` runs any plan kind.  Frozen and
    hashable."""

    devices: tuple = ()
    min_nnz_per_part: int = MIN_NNZ_PER_PART
    min_features_per_part: int = MIN_FEATURES_PER_PART

    def __post_init__(self):
        pool = tuple(self.devices) or cuda_pool()
        object.__setattr__(self, "devices", tuple(pool_device(d) for d in pool))

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def devices_for(self, decision: ShardingDecision) -> tuple[tuple[torch.device, ...], ...]:
        """The ``[tile_parts][feature_parts]`` grid over a prefix of the
        pool (the reference's ``mesh_for``)."""
        d = decision.n_devices
        if d > self.n_devices:
            raise ValueError(
                f"decision needs {d} devices, executor has {self.n_devices}"
            )
        fp = decision.feature_parts
        return tuple(
            tuple(self.devices[p * fp: (p + 1) * fp]) for p in range(decision.tile_parts)
        )

    def decide_for(
        self, nnz: int, n_features: int, n_rows: Optional[int] = None,
        n_slots: Optional[int] = None,
    ) -> ShardingDecision:
        """Decision from workload numbers (the serving engine sums member
        nnz before any plan exists)."""
        return decide_sharding(
            nnz, n_features, self.n_devices,
            n_rows=n_rows,
            min_nnz_per_part=self.min_nnz_per_part,
            min_features_per_part=self.min_features_per_part,
            n_slots=n_slots,
        )

    def decide(
        self, plan: Union[SCVPlan, SCVBucketedPlan], n_features: int
    ) -> ShardingDecision:
        """Decision from a built plan: its nnz (read back) and its launched
        slots, which price the plan triple at the real padded arrays."""
        from repro_torch.tune.cost import plan_launched_slots

        segs = getattr(plan, "segments", (plan,))
        nnz = int(sum(int(s.nnz_in_tile.sum()) for s in segs))
        return self.decide_for(
            nnz, n_features, n_rows=plan.shape[0],
            n_slots=plan_launched_slots(plan),
        )

    def prepare(
        self,
        plan: Union[SCVPlan, SCVBucketedPlan],
        n_features: Optional[int] = None,
        decision: Optional[ShardingDecision] = None,
    ) -> Union[SCVPlan, SCVBucketedPlan, ShardedPlan]:
        """Place a plan: the equal-nnz split of each segment (the host reads
        its ``tile_row`` and ``nnz_in_tile`` once), the span gather where the
        plan lives (``partition.shard_plan``), and per span its padding
        rewritten, its run index built from the host copies, and its leaves
        moved to its grid row's first device.

        A ``replicated`` decision returns the plan unchanged.  Pass
        ``decision`` or ``n_features`` (then ``decide`` picks)."""
        if decision is None:
            if n_features is None:
                raise ValueError("prepare needs a decision or n_features")
            decision = self.decide(plan, n_features)
        if decision.kind == "replicated":
            return plan
        grid = self.devices_for(decision)
        tp = decision.tile_parts
        segs = getattr(plan, "segments", (plan,))
        host = [(s.tile_row.cpu().numpy(), s.nnz_in_tile.cpu().numpy()) for s in segs]
        parts = tuple(partition_of(nnz, tp) for _, nnz in host)
        stacked = shard_plan(plan, parts if isinstance(plan, SCVBucketedPlan) else parts[0])
        return ShardedPlan(
            segments=tuple(
                _spans(s, part, tr, nnz, grid)
                for s, part, (tr, nnz) in zip(getattr(stacked, "segments", (stacked,)),
                                              parts, host)
            ),
            devices=grid,
            decision=decision,
        )

    def aggregate(self, plan, z: torch.Tensor) -> torch.Tensor:
        """Run any plan kind: a sharded plan over its grid, any other on its
        own device (``aggregate_scv_plan``)."""
        from repro_torch.core.aggregate import aggregate_scv_plan

        return aggregate_scv_plan(plan, z)

    def prepare_graph(self, g, n_features: Optional[int] = None,
                      decision: Optional[ShardingDecision] = None):
        """Place a ``models.gnn.Graph``'s plan; its edge arrays (read by
        GAT's attention only) go to the output device."""
        placed = self.prepare(g.plan, n_features=n_features, decision=decision)
        if placed is g.plan:
            return g
        edges = {k: getattr(g, k).to(placed.device) for k in ("rows", "cols", "vals")
                 if getattr(g, k) is not None}
        return dataclasses.replace(g, plan=placed, **edges)


def _spans(seg: SCVPlan, part, tile_row: np.ndarray, nnz: np.ndarray, grid) -> tuple:
    """Cut one stacked segment (``shard_plan``'s result) into its spans.

    Padded slots (coordinates 0 after the gather) take the span's last real
    tile's coordinates, as the reference rewrites them: the TPU kernel
    re-seeds a strip whenever ``tile_row`` changes.  The port's kernel
    schedules by run index instead, and the rewrite keeps the padding in
    the span's last run, past its last entry, where it lies in no work
    unit; an all-pad span keeps coordinate 0 and one empty unit, which in
    the zero-seeded chain writes its strip back unchanged (and the
    executor does not launch a span without entries at all)."""
    tp, width = part.part_tiles.shape
    real = part.part_tiles >= 0
    n_real = real.sum(1)
    src = np.minimum(np.arange(width)[None, :], np.maximum(n_real - 1, 0)[:, None])
    src = np.where(n_real[:, None] > 0, src, np.arange(width)[None, :])
    src_t = torch.from_numpy(src.astype(np.int64)).to(seg.device)
    idx = np.maximum(part.part_tiles, 0)

    def host(a: np.ndarray) -> np.ndarray:
        return np.where(real, a[idx], 0) if a.size else np.zeros((tp, width), a.dtype)

    host_row = np.take_along_axis(host(tile_row), src, 1)
    host_nnz = host(nnz)
    leaves = {
        name: None if getattr(seg, name) is None
        else getattr(seg, name).reshape((tp, width) + tuple(getattr(seg, name).shape[1:]))
        for name in _LEAVES
    }
    for name in ("tile_row", "tile_col"):
        leaves[name] = torch.take_along_dim(leaves[name], src_t, dim=1)
    spans = []
    for p in range(tp):
        dev = grid[p][0]
        spans.append(dataclasses.replace(
            seg,
            **{name: None if v is None else v[p].to(dev) for name, v in leaves.items()},
            runs=RunIndex.of(host_row[p], host_nnz[p], dev),
        ))
    return tuple(spans)
