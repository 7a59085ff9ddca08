"""Error-feedback int8 gradient compression for the cross-pod axis.

Port of ``src/repro/optim/compress.py``:

* ``quantize/dequantize`` -- per-tensor symmetric int8 with a float32
  scale ``max|x| / 127 + 1e-12``, rounding half to even (``torch.round``,
  as ``jnp.round``);
* ``ef_state/compress_with_feedback`` -- error-feedback accumulation
  (Karimireddy et al.: feed back the quantization residual next step so the
  compressed SGD converges like the uncompressed one);
* ``compressed_psum`` -- the all-reduce.  The reference runs it inside
  ``shard_map`` over the "pod" axis, one program per member.  Here one
  process holds every member: it takes one gradient tree and one error
  tree per member, each on its pool device, and sums the int8 payloads on
  the first member's device.

These are elementwise passes and a max (the reference's own jnp ops; no
Pallas kernel stands behind them), so plain PyTorch is the counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` rounded once, as ``jnp``'s division: on a card, dividing by
    a Python number multiplies by its reciprocal (one more rounding), so
    ``d`` goes to ``x``'s device as a tensor first."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _div(x.abs().max(), 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_state(params):
    """Zero float32 residuals shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_with_feedback(grads, errors):
    """Returns (quantized_tree, scales_tree, new_errors)."""
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads, errors)
    flat = [quantize(c) for c in leaves(corrected)]
    q = unflatten(corrected, [t[0] for t in flat])
    s = unflatten(corrected, [t[1] for t in flat])
    new_err = tree_map(lambda c, qq, ss: c - dequantize(qq, ss), corrected, q, s)
    return q, s, new_err


def compressed_psum(grads, errors, axis_name: str):
    """All-reduce int8-compressed grads over the members of ``axis_name``.

    ``grads`` and ``errors`` hold one tree per member (the reference's
    ``shard_map`` programs), each on that member's device.  A shared
    per-tensor scale (the max of the members' local maxima) makes the
    integer summation exact: the int8 payloads are summed as int32 in
    member order on the first member's device, so the result is the same
    bits in any order.  Returns ``(mean_grads, new_errors)``: the mean on
    the first member's device, and each member's residual (fed back next
    step) on its own.  Under an active mesh ``axis_name`` must be one of
    its axes, of the members' count."""
    from repro_torch.train.sharding import active_mesh

    n = len(grads)
    if n == 0 or len(errors) != n:
        raise ValueError(f"{n} gradient trees and {len(errors)} error trees")
    mesh = active_mesh()
    if mesh is not None and mesh.shape.get(axis_name) != n:
        raise ValueError(f"axis {axis_name!r} of {dict(mesh.shape)} for {n} members")
    flat_g = [leaves(g) for g in grads]
    flat_e = [leaves(e) for e in errors]
    home = flat_g[0][0].device if flat_g[0] else torch.device("cpu")
    means, new_errs = [], [[] for _ in range(n)]
    for j in range(len(flat_g[0])):
        xs = [flat_g[i][j].to(torch.float32) + flat_e[i][j] for i in range(n)]
        local = torch.stack([x.abs().max().to(home) for x in xs])
        scale = _div(local.max(), 127.0) + 1e-12
        summed = None
        for i, x in enumerate(xs):
            s = scale.to(x.device)
            q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            new_errs[i].append(x - q.to(torch.float32) * s)
            q32 = q.to(home, torch.int32)
            summed = q32 if summed is None else summed + q32
        means.append(_div(summed.to(torch.float32) * scale, n))
    return (unflatten(grads[0], means),
            [unflatten(errors[i], new_errs[i]) for i in range(n)])
