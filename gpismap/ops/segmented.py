"""Segmented (per-cell) batched evaluation.

The map test path assigns each (query, rank) pair to one cluster cell; each
cell owns a moderately large GP factor (M' x M'), so per-pair gathers of the
factor are bandwidth-prohibitive. Instead, pairs are bucketed by cell into
fixed-size tiles (each tile touches exactly ONE cell) and evaluated by a
scan that gathers one cell's state per tile — bounded memory footprint, pure
matmuls inside, load-balanced up to T-1 padding per cell.

This replaces the reference's per-point loop over up-to-3 neighbour GPs
(reference: GPisMap.cpp:665-763) with a batched schedule.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TilePlan(NamedTuple):
    pair_ids: jnp.ndarray   # [NT, T] original pair index per padded slot, -1
    tile_seg: jnp.ndarray   # [NT] segment (cell) id per tile, -1 inactive
    n_tiles: jnp.ndarray    # scalar — tiles actually used


def plan_tiles(seg: jnp.ndarray, n_segments: int, tile: int) -> TilePlan:
    """Bucket pair indices by segment into single-segment tiles.

    seg: [P] int32 segment id per pair, -1 for inactive pairs.
    Static output size NT = P // tile + n_segments (worst case: every
    segment's remainder opens one extra tile).

    Gather formulation: after the packed-key sort, tile t of segment s
    covers sorted positions start_in_sorted[s] + (t - tile_start[s])*T
    + j, so pair_ids is ONE [NT, T] gather of the sorted order — no [P]
    rank/scatter passes. Outputs are identical arrays (exactness gated
    by tests/test_segmented_plan.py vs the scatter reference).
    """
    p = seg.shape[0]
    nt = p // tile + n_segments
    valid = seg >= 0
    segc = jnp.where(valid, seg, n_segments).astype(jnp.int32)
    p2 = 1 << max(0, (p - 1)).bit_length()
    packed = (n_segments + 1) * p2 < 2 ** 31
    if packed:
        # stable sort via one packed int32 key (seg * P2 + index): a
        # single-operand sort instead of argsort's (key, iota) pair sort
        key = segc * p2 + jnp.arange(p, dtype=jnp.int32)
        skey = jnp.sort(key)
        order = skey            # pair index recovered by & (p2-1) below
        # segment boundaries straight from the sorted keys: the first
        # pair of segment s sits at searchsorted(skey, s * P2) — one
        # [S+1]-query binary search over the sorted keys replaces the
        # [P]-element scatter-add bincount
        bounds = jnp.searchsorted(
            skey, jnp.arange(n_segments + 1, dtype=jnp.int32) * p2,
            side='left').astype(jnp.int32)
        counts = bounds[1:] - bounds[:-1]
        start_in_sorted = bounds[:-1]
    else:
        order = jnp.argsort(segc, stable=True).astype(jnp.int32)
        counts = jnp.bincount(segc, length=n_segments + 1)[:n_segments]
        start_in_sorted = jnp.cumsum(counts) - counts

    tiles_per = (counts + tile - 1) // tile
    tile_start = jnp.cumsum(tiles_per) - tiles_per          # first tile of seg
    n_tiles = jnp.sum(tiles_per)

    # tile t belongs to segment s iff tile_start[s] <= t < tile_start[s]+tiles_per[s]
    tidx = jnp.arange(nt)
    seg_of_tile = jnp.searchsorted(jnp.cumsum(tiles_per), tidx, side='right')
    seg_of_tile = jnp.where(tidx < n_tiles, seg_of_tile, -1).astype(jnp.int32)

    sot_c = jnp.clip(seg_of_tile, 0, n_segments - 1)
    local = (tidx - tile_start[sot_c]) * tile               # [NT]
    base = start_in_sorted[sot_c] + local
    j = jnp.arange(tile)
    within = ((local[:, None] + j[None, :] < counts[sot_c][:, None])
              & (seg_of_tile >= 0)[:, None])
    # tile t reads CONTIGUOUS sorted positions base[t]..base[t]+T-1:
    # one slice-per-index gather (see _slice_rows) instead of a [NT, T]
    # random element gather.
    gathered = _slice_rows(order, base, tile, p)
    if packed:
        # the slices read the sorted KEYS and strip the segment bits
        # in-place — no [P] `order` array is ever materialised
        gathered = gathered & (p2 - 1)
    pair_ids = jnp.where(within, gathered, -1)
    return TilePlan(pair_ids=pair_ids, tile_seg=seg_of_tile,
                    n_tiles=n_tiles)


def plan_tiles_for_slots(seg: jnp.ndarray, uniq: jnp.ndarray,
                         max_cells: int, n_segments: int, tile: int):
    """plan_tiles directly from RAW slot ids + the sorted active-slot
    list — no per-pair slot->compact translation.

    seg: [P] raw slot ids per pair (-1 inactive); uniq: [n_segments]
    SORTED unique active slots, int32-max padded. Compact segment s
    covers the pairs whose slot equals uniq[s]; pairs whose slot is
    absent from uniq are dropped (they sort between segment ranges and
    no range covers them).

    Returns (TilePlan, n_in_plan). The plan is ARRAY-IDENTICAL to
    `plan_tiles(lut_compact(seg, uniq), n_segments, tile)` (gated by
    tests/test_segmented_plan.py): segments in uniq order = ascending
    slot order, stable original order within each segment. The point is
    the cost: the dense-LUT compaction is a [P]-element random gather,
    while the segment ranges here come from ONE [2, S]-query binary
    search over the already sorted keys.
    """
    p = seg.shape[0]
    nt = p // tile + n_segments
    big = jnp.iinfo(jnp.int32).max
    in_range = (seg >= 0) & (seg < max_cells)
    segc = jnp.where(in_range, seg, max_cells).astype(jnp.int32)
    p2 = 1 << max(0, (p - 1)).bit_length()
    uq = jnp.where(uniq < big, uniq, max_cells).astype(jnp.int32)
    if (max_cells + 1) * p2 < 2 ** 31:
        key = segc * p2 + jnp.arange(p, dtype=jnp.int32)
        skey = jnp.sort(key)
        bounds = jnp.searchsorted(
            skey, jnp.stack([uq, uq + 1]) * p2, side='left'
        ).astype(jnp.int32)                                  # [2, S]
        counts = jnp.where(uniq < big, bounds[1] - bounds[0], 0)
        start_in_sorted = bounds[0]
        order = skey
        mask_bits = p2 - 1
    else:
        order = jnp.argsort(segc, stable=True).astype(jnp.int32)
        bc = jnp.bincount(segc, length=max_cells + 1)
        starts_all = jnp.cumsum(bc) - bc
        counts = jnp.where(uniq < big, bc[uq], 0)
        start_in_sorted = starts_all[uq].astype(jnp.int32)
        mask_bits = -1                                       # no strip

    tiles_per = (counts + tile - 1) // tile
    tile_start = jnp.cumsum(tiles_per) - tiles_per
    n_tiles = jnp.sum(tiles_per)
    tidx = jnp.arange(nt)
    seg_of_tile = jnp.searchsorted(jnp.cumsum(tiles_per), tidx,
                                   side='right')
    seg_of_tile = jnp.where(tidx < n_tiles, seg_of_tile, -1).astype(
        jnp.int32)
    sot_c = jnp.clip(seg_of_tile, 0, n_segments - 1)
    local = (tidx - tile_start[sot_c]) * tile
    base = start_in_sorted[sot_c] + local
    j = jnp.arange(tile)
    within = ((local[:, None] + j[None, :] < counts[sot_c][:, None])
              & (seg_of_tile >= 0)[:, None])
    gathered = _slice_rows(order, base, tile, p)
    if mask_bits >= 0:
        gathered = gathered & mask_bits
    pair_ids = jnp.where(within, gathered, -1)
    plan = TilePlan(pair_ids=pair_ids, tile_seg=seg_of_tile,
                    n_tiles=n_tiles)
    return plan, jnp.sum(counts).astype(jnp.int32)


def _slice_rows(order: jnp.ndarray, base: jnp.ndarray, tile: int,
                p: int) -> jnp.ndarray:
    """[NT, T] read of contiguous runs order[base[t] : base[t]+T].

    One lax.gather with a T-wide slice per index instead of an [NT, T]
    random element gather. The source is padded by one full tile and base
    clipped to [0, P] so a partial final tile never triggers start
    clamping, which would shift its valid elements; padding rows are
    masked by the caller's `within`."""
    src = jnp.concatenate([order, jnp.full((tile,), -1, order.dtype)])
    base_c = jnp.clip(base, 0, p)
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(),
        start_index_map=(0,))
    return jax.lax.gather(
        src, base_c[:, None], dnums, slice_sizes=(tile,),
        mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS)


def _plan_tiles_scatter_ref(seg: jnp.ndarray, n_segments: int,
                            tile: int) -> TilePlan:
    """Round-4 scatter formulation of plan_tiles, kept ONLY as the
    test oracle for the gather formulation's exact equality
    (tests/test_segmented_plan.py)."""
    p = seg.shape[0]
    nt = p // tile + n_segments
    valid = seg >= 0
    segc = jnp.where(valid, seg, n_segments).astype(jnp.int32)
    order = jnp.argsort(segc, stable=True)
    sorted_seg = segc[order]

    counts = jnp.bincount(segc, length=n_segments + 1)[:n_segments]
    tiles_per = (counts + tile - 1) // tile
    tile_start = jnp.cumsum(tiles_per) - tiles_per
    n_tiles = jnp.sum(tiles_per)

    start_in_sorted = jnp.cumsum(counts) - counts
    sseg_c = jnp.clip(sorted_seg, 0, n_segments - 1)
    rank = jnp.arange(p) - start_in_sorted[sseg_c]
    padded_pos = tile_start[sseg_c] * tile + rank
    padded_pos = jnp.where(sorted_seg < n_segments, padded_pos, nt * tile)

    pair_ids = jnp.full((nt * tile + 1,), -1, jnp.int32)
    pair_ids = pair_ids.at[padded_pos].set(order.astype(jnp.int32))
    pair_ids = pair_ids[:-1].reshape(nt, tile)

    tidx = jnp.arange(nt)
    seg_of_tile = jnp.searchsorted(jnp.cumsum(tiles_per), tidx, side='right')
    seg_of_tile = jnp.where(tidx < n_tiles, seg_of_tile, -1).astype(jnp.int32)
    return TilePlan(pair_ids=pair_ids, tile_seg=seg_of_tile, n_tiles=n_tiles)


def segmented_eval(plan: TilePlan, eval_tile, out_init,
                   tile_chunk: int = 32, vma_axes: tuple = (),
                   remat: bool = False):
    """Run eval_tile over tiles, scattering tile results into out arrays.

    eval_tile(seg_ids [G], pair_ids [G, T]) -> pytree of [G, T, ...] results
    (G = tile_chunk tiles evaluated together; seg_ids may be -1 = skip).
    out_init: pytree of [P, ...] output arrays (pre-filled defaults).
    Returns the filled pytree.

    vma_axes: when called inside shard_map (manual mode), the mesh axis
    names — the scan carry is marked device-varying up front so the
    lax.cond branches (skip vs compute) have matching types.

    remat: checkpoint each chunk's compute — jax.grad then recomputes a
    chunk's gathers/matmuls instead of materializing every chunk's
    residuals across the scan (at 3D shapes one chunk's gathered
    factors are [32, 1280, 1280] = 200 MB; ~70 chunks of saved
    residuals crash the compile service). Free in forward-only use.
    """
    nt, tile = plan.pair_ids.shape
    pad_t = (-nt) % tile_chunk
    pair_ids = jnp.concatenate(
        [plan.pair_ids, jnp.full((pad_t, tile), -1, jnp.int32)])
    tile_seg = jnp.concatenate(
        [plan.tile_seg, jnp.full((pad_t,), -1, jnp.int32)])
    ngrp = (nt + pad_t) // tile_chunk
    pair_ids = pair_ids.reshape(ngrp, tile_chunk, tile)
    tile_seg = tile_seg.reshape(ngrp, tile_chunk)

    # masked writes drop onto a dummy trailing row (avoids duplicate-index
    # set nondeterminism)
    p = jax.tree.leaves(out_init)[0].shape[0]
    out_ext = jax.tree.map(
        lambda o: jnp.concatenate([o, jnp.zeros((1,) + o.shape[1:], o.dtype)]),
        out_init)
    if vma_axes:
        out_ext = jax.tree.map(
            lambda o: jax.lax.pcast(o, vma_axes, to='varying'), out_ext)

    def compute(out, segs, pids):
        res = eval_tile(segs, pids)             # pytree [G, T, ...]
        mask = (pids >= 0) & (segs[:, None] >= 0)
        tgt = jnp.where(mask, pids, p).reshape(-1)

        def scatter(o, r):
            r2 = r.reshape((tgt.shape[0],) + r.shape[2:])
            return o.at[tgt].set(r2, mode='drop')

        return jax.tree.map(scatter, out, res)

    if remat:
        compute = jax.checkpoint(compute)

    def body(out, args):
        segs, pids = args                       # [G], [G, T]
        # tiles are packed densely at the front; all-empty chunks (the
        # static padding up to NT) skip the factorization entirely
        out = jax.lax.cond(jnp.any(segs >= 0),
                           lambda o: compute(o, segs, pids),
                           lambda o: o, out)
        return out, None

    out, _ = jax.lax.scan(body, out_ext, (tile_seg, pair_ids))
    return jax.tree.map(lambda o: o[:-1], out)
