"""Plain PyTorch versions of the SCV SpMM kernel's bodies.

Port of ``src/repro/kernels/scv_spmm/ref.py``, plus the dense-tile branch:

* ``scv_spmm_reference`` — a gather of Z rows and one ``index_add_`` into
  the output.  The plain version of the scalar body and of the vector
  body's sparse branch (the same function, entry by entry).
* ``scv_spmm_dense_reference`` — the dense branch: the chosen tiles
  densified to ``[n, T, T]`` (duplicates summed), times their Z blocks.
* ``scv_spmm_vector_reference`` — the vector body: tiles over the dense
  threshold through the dense version, the rest through the gather.

The launch wrapper takes them for CPU tensors, the CPU tests hold the port
against the reference with them, and ``chip_smoke.py`` compares the CUDA
kernels with them on the card.  They are never the CUDA path of the port.

Two plain models of the CUDA vector body's own arithmetic, which the CPU
tests reach and the CPU path does not take:

* ``tf32x3_matmul`` — the dense branch's product on the tensor cores: each
  operand split into a big and a small part, each rounded to TF32
  (``tf32_round``), and small·big + big·small + big·big summed in f32;
* ``scv_spmm_chain_units_reference`` — one launch over a chain's
  plan-level index (``core.scv.PlanRuns``): each work unit's partial strip
  over its pieces, then each run's seed plus its partials summed over the
  kernel's merge tree (``tree_sum``).
"""
from __future__ import annotations

import torch


def _live_vals(vals: torch.Tensor, nnz_in_tile: torch.Tensor | None) -> torch.Tensor:
    """``vals`` with the slots past each tile's nnz zeroed."""
    if nnz_in_tile is None:
        return vals
    slot = torch.arange(vals.shape[1], device=vals.device)[None, :]
    return torch.where(slot < nnz_in_tile[:, None], vals, 0.0)


def scv_spmm_reference(
    tile_row: torch.Tensor,  # i32[nt]
    tile_col: torch.Tensor,  # i32[nt]
    rows: torch.Tensor,  # i32[nt, cap] local row within tile
    cols: torch.Tensor,  # i32[nt, cap] local col within tile
    vals: torch.Tensor,  # f32[nt, cap] (0 for padding slots)
    z: torch.Tensor,  # [n_cols, F] dense combined features
    *,
    tile: int,
    n_rows: int,
    nnz_in_tile: torch.Tensor | None = None,  # i32[nt] — masks padding slots
) -> torch.Tensor:
    """out[tile_row*T + rows] += vals * z[tile_col*T + cols]  (f32)."""
    out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    if tile_row.shape[0] == 0:
        return out
    vals = _live_vals(vals, nnz_in_tile)
    gcols = (tile_col[:, None].long() * tile + cols).reshape(-1)
    grows = (tile_row[:, None].long() * tile + rows).reshape(-1)
    gathered = z[gcols].float() * vals.reshape(-1, 1).float()
    return out.index_add_(0, grows, gathered)


def scv_spmm_dense_reference(
    tile_row: torch.Tensor,  # i32[nd] — the tiles to densify
    tile_col: torch.Tensor,  # i32[nd]
    rows: torch.Tensor,  # i32[nd, cap]
    cols: torch.Tensor,  # i32[nd, cap]
    vals: torch.Tensor,  # f32[nd, cap]
    z: torch.Tensor,  # [n_cols, F]
    *,
    tile: int,
    n_rows: int,
    nnz_in_tile: torch.Tensor | None = None,
    product=torch.bmm,
) -> torch.Tensor:
    """The dense branch over every tile given: D_t (T x T) from the
    tile's entries, duplicates summed, then ``out[strip] += D_t @ Z_block``
    (``product``: the batched product, f32 ``torch.bmm`` or
    :func:`tf32x3_matmul`).  Z rows past ``z.shape[0]`` count as zero, as
    in the kernel."""
    T = tile
    n, f = tile_row.shape[0], z.shape[1]
    out = torch.zeros((n_rows, f), dtype=torch.float32, device=z.device)
    if n == 0:
        return out
    vals = _live_vals(vals, nnz_in_tile).float()
    d = torch.zeros((n, T, T), dtype=torch.float32, device=z.device)
    which = torch.arange(n, device=z.device)[:, None].expand_as(rows)
    d.index_put_((which, rows.long(), cols.long()), vals, accumulate=True)
    block_rows = tile_col[:, None].long() * T + torch.arange(T, device=z.device)
    zp = z.float()
    n_blocks_rows = int(block_rows.max()) + 1
    if zp.shape[0] < n_blocks_rows:
        zp = torch.cat([zp, zp.new_zeros((n_blocks_rows - zp.shape[0], f))])
    part = product(d, zp[block_rows])  # [n, T, F]
    strip_rows = tile_row[:, None].long() * T + torch.arange(T, device=z.device)
    return out.index_add_(0, strip_rows.reshape(-1), part.reshape(-1, f))


def dense_tiles(nnz_in_tile: torch.Tensor, dense_threshold: int) -> torch.Tensor:
    """Which tiles take the dense branch: ``0 <= threshold < nnz`` (the
    reference's rule, ``scv_spmm.py:147-148``)."""
    if dense_threshold < 0:
        return torch.zeros_like(nnz_in_tile, dtype=torch.bool)
    return nnz_in_tile > dense_threshold


def scv_spmm_vector_reference(
    tile_row, tile_col, rows, cols, vals, z, *, tile: int, n_rows: int,
    nnz_in_tile: torch.Tensor, dense_threshold: int,
) -> torch.Tensor:
    """The vector body: tiles over ``dense_threshold`` densified (see
    :func:`scv_spmm_dense_reference`), the others gathered."""
    dense = dense_tiles(nnz_in_tile, dense_threshold)
    sparse = ~dense
    kw = dict(tile=tile, n_rows=n_rows)
    out = scv_spmm_reference(
        tile_row[sparse], tile_col[sparse], rows[sparse], cols[sparse], vals[sparse], z,
        nnz_in_tile=nnz_in_tile[sparse], **kw,
    )
    if bool(dense.any()):
        out += scv_spmm_dense_reference(
            tile_row[dense], tile_col[dense], rows[dense], cols[dense], vals[dense], z,
            nnz_in_tile=nnz_in_tile[dense], **kw,
        )
    return out


def scv_spmm_reference_plan(
    plan, z: torch.Tensor, *, body: str = "scalar", dense_threshold: int | None = None,
) -> torch.Tensor:
    """Plain version over an ``SCVPlan`` or ``SCVBucketedPlan``.  Returns
    the padded ``[n_rows_p, F]`` output, like ``ops.scv_spmm_plan``;
    segment partials are summed.  ``body="scalar"`` gathers every entry;
    ``body="vector"`` sends tiles over ``dense_threshold`` (``None``: the
    reference's ``dense_tile_threshold(T)``) through the dense version."""
    from repro_torch.core.scv import dense_tile_threshold

    n_rows = plan.padded_shape[0]
    segments = getattr(plan, "segments", (plan,))
    out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    for seg in segments:
        args = (seg.tile_row, seg.tile_col, seg.rows, seg.cols, seg.vals, z)
        kw = dict(tile=seg.tile, n_rows=n_rows, nnz_in_tile=seg.nnz_in_tile)
        if body == "vector":
            thr = dense_tile_threshold(seg.tile) if dense_threshold is None else dense_threshold
            out = out + scv_spmm_vector_reference(*args, dense_threshold=thr, **kw)
        elif body == "scalar":
            out = out + scv_spmm_reference(*args, **kw)
        else:
            raise ValueError(f"unknown kernel body {body!r}")
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32, as ``cvt.rna.tf32.f32`` rounds: to 10
    mantissa bits, to nearest with ties away from zero, by adding half a
    TF32 unit to the magnitude's bits and masking the 13 low ones."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x = big + small`` as the dense branch splits it: ``big`` is ``x``
    rounded to TF32, ``small`` the rest rounded to TF32 (zero for an
    integer below 2^11 in magnitude, which TF32 holds exactly)."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched or not) in the dense branch's 3xTF32 split: the
    products small·big, big·small and big·big, summed in f32 in that
    order (small·small dropped).  Exact where each product and sum is (the
    integer inputs of the tests); otherwise within a few f32 units of
    ``a @ b`` per term."""
    ab, asm = tf32_split(a)
    bb, bsm = tf32_split(b)
    return (asm @ bb + ab @ bsm) + ab @ bb


def tree_sum(parts):
    """A split run's partial strips summed as the kernels' merge sums them
    (``csrc/scv_spmm.cu::finish_unit``): over a fixed binary tree of the
    run's units, nodes ``2i`` and ``2i + 1`` of each level meeting in their
    parent, an odd one out climbing alone."""
    parts = list(parts)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def scv_spmm_chain_units_reference(segments, vals, z, runs, out, *, accumulate: bool,
                                   dense_threshold: int) -> torch.Tensor:
    """One vector launch over a chain, summed as the kernel sums it, on the
    plan-level index ``runs`` (``core.scv.PlanRuns`` of the segments' run
    indexes): for each run (a block-row), each work unit's partial strip,
    from zero, over its pieces in order (each piece a span of one
    segment's tiles: its gathered entries, and its dense tiles through
    :func:`tf32x3_matmul`), then the seed (``out``'s strip with
    ``accumulate``, else zero) plus the partials summed by
    :func:`tree_sum`.  Rows that no run visits keep ``out``'s contents.
    Returns a new tensor."""
    T, F = segments[0].tile, z.shape[1]
    pieces = runs.pieces.cpu().numpy()
    units = runs.units.cpu().numpy()
    unit_ptr = runs.unit_ptr.cpu().numpy()
    res = out.clone()
    for r, row in enumerate(runs.rows.tolist()):
        strip = slice(row * T, (row + 1) * T)
        parts = []
        for u in range(int(unit_ptr[r]), int(unit_ptr[r + 1])):
            part = z.new_zeros((T, F))
            for k, b, e, _ in pieces[units[u, 0]:units[u, 1]].tolist():
                s, sl = segments[k], slice(b, e)
                args = (s.tile_row[sl], s.tile_col[sl], s.rows[sl], s.cols[sl], vals[k][sl], z)
                nnz = s.nnz_in_tile[sl]
                dense = dense_tiles(nnz, dense_threshold)
                kw = dict(tile=T, n_rows=out.shape[0])
                part = part + scv_spmm_reference(
                    *(a[~dense] for a in args[:5]), z, nnz_in_tile=nnz[~dense], **kw)[strip]
                part = part + scv_spmm_dense_reference(
                    *(a[dense] for a in args[:5]), z, nnz_in_tile=nnz[dense],
                    product=tf32x3_matmul, **kw)[strip]
            parts.append(part)
        seed = out[strip] if accumulate else z.new_zeros((T, F))
        res[strip] = seed + tree_sum(parts)
    return res
