"""Cluster-GP store + batched map test path.

Device-resident per-cluster GP state in flat slot-indexed arrays (the
device-resident replacement for the reference's per-QuadTree shared_ptr<OnGPIS>
registry, quadtree.h:124), plus the batched SDF query with 3-nearest-cell
variance blending (reference: GPisMap.cpp:665-763 / GPisMap3.cpp:794-902).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CapacityParam, MapperParam, TreeParam
from ..ops import gp, kernels, precision, segmented


class ClusterStore(NamedTuple):
    """Per-slot trained cluster GPs, slot-indexed [C, ...].

    Deliberately stores NO Cholesky factors: real support sizes reach
    hundreds of nodes (3D: median ~125, max ~270 on the bundled data), so
    persistent [C, M', M'] factors would cost gigabytes. Instead the small
    support data + alpha persist and the factor is rebuilt inside the test
    tile scan — a few 1e8-flop Cholesky factorizations per tile are cheap,
    device memory is not.
    """

    x: jnp.ndarray         # [C, M, D] support positions
    grad: jnp.ndarray      # [C, M, D] support normals
    val: jnp.ndarray       # [C, M] SDF targets
    sigx: jnp.ndarray      # [C, M] position noise (pre-adjustment)
    siggrad: jnp.ndarray   # [C, M] gradient noise
    valid: jnp.ndarray     # [C, M] bool
    alpha: jnp.ndarray     # [C, M*(1+D)]
    trained: jnp.ndarray   # [C] bool


def make_store(cap: CapacityParam, dim: int) -> ClusterStore:
    c, m = cap.max_cells, cap.gp_support
    mp = m * (1 + dim)
    return ClusterStore(
        x=jnp.zeros((c, m, dim), jnp.float32),
        grad=jnp.zeros((c, m, dim), jnp.float32),
        val=jnp.zeros((c, m), jnp.float32),
        sigx=jnp.zeros((c, m), jnp.float32),
        siggrad=jnp.zeros((c, m), jnp.float32),
        valid=jnp.zeros((c, m), bool),
        alpha=jnp.zeros((c, mp), jnp.float32),
        trained=jnp.zeros((c,), bool),
    )


def _retrain_impl(store: ClusterStore, slots: jnp.ndarray,
                  slot_ok: jnp.ndarray, x: jnp.ndarray, grad: jnp.ndarray,
                  val: jnp.ndarray, sigx: jnp.ndarray, siggrad: jnp.ndarray,
                  valid: jnp.ndarray, scale):
    """Fit a batch of cluster GPs and scatter them into their slots.

    `scale` is a traced scalar (hyperparameter gradients flow through the
    fit; reference hyperparams: covFnc.cpp:29-33, params.h:73-93).

    Batched analogue of the thread fan-out in updateGPs (GPisMap.cpp:596-663):
    one batched Cholesky over [B, M', M'] instead of per-cell Eigen llt on
    CPU threads. Only alpha + the raw support data persist (see
    ClusterStore).

    slots: [B] destination slot per cell (-1 rows dropped via slot_ok).

    Size-bucket support: the batch may carry FEWER support rows than the
    store capacity (x: [B, mb, D] with mb <= M). The fit then runs at the
    small size — (mb/M)^3 of the full-padding Cholesky FLOPs — and the
    results are zero-padded into the store layout. Masked identity-row
    padding makes this exactly equivalent to fitting at M (see
    ops/kernels.py); callers bucket cells by support count (SURVEY §7
    load-balancing by size bucket).
    """
    st = gp.fit_ongpis(x, grad, val, sigx, siggrad, valid, scale)
    m = store.x.shape[1]
    mb = x.shape[1]
    d = x.shape[-1]
    if mb < m:
        def padm(a):
            w = [(0, 0), (0, m - mb)] + [(0, 0)] * (a.ndim - 2)
            return jnp.pad(a, w)

        x, grad = padm(x), padm(grad)
        val, sigx, siggrad = padm(val), padm(sigx), padm(siggrad)
        valid = padm(valid)
        # alpha layout is per-block [f(M), gx(M), gy(M)(, gz(M))]: pad each
        # block from mb to M (padded rows have alpha == 0 by masking)
        alpha = st.alpha.reshape(-1, 1 + d, mb)
        alpha = jnp.pad(alpha, [(0, 0), (0, 0), (0, m - mb)])
        alpha = alpha.reshape(-1, (1 + d) * m)
        st = st._replace(alpha=alpha)
    c = store.x.shape[0]
    tgt = jnp.where(slot_ok, slots, c)

    def scat(old, new):
        ext = jnp.concatenate([old, jnp.zeros((1,) + old.shape[1:],
                                              old.dtype)])
        return ext.at[tgt].set(new, mode='drop')[:-1]

    new_store = ClusterStore(
        x=scat(store.x, x),
        grad=scat(store.grad, grad),
        val=scat(store.val, val),
        sigx=scat(store.sigx, sigx),
        siggrad=scat(store.siggrad, siggrad),
        valid=scat(store.valid, valid),
        alpha=scat(store.alpha, st.alpha),
        trained=scat(store.trained, jnp.any(valid, -1)),
    )
    return new_store, st.l


@jax.jit
def retrain_cells(store: ClusterStore, slots: jnp.ndarray,
                  slot_ok: jnp.ndarray, x: jnp.ndarray, grad: jnp.ndarray,
                  val: jnp.ndarray, sigx: jnp.ndarray, siggrad: jnp.ndarray,
                  valid: jnp.ndarray, scale) -> ClusterStore:
    """_retrain_impl without the Cholesky factor (callers that do not
    maintain the factor cache)."""
    return _retrain_impl(store, slots, slot_ok, x, grad, val, sigx,
                         siggrad, valid, scale)[0]


class NodeMirror(NamedTuple):
    """Device-resident mirror of the host node table (SURVEY §7's
    device-resident struct-of-arrays). Kept in sync by scattering only the
    nodes each frame MUTATES (api._sync_mirror), so the retrain can
    gather its support data on device from uploaded INDICES instead of
    uploading five gathered support arrays every frame."""

    pos: jnp.ndarray       # [N, D]
    grad: jnp.ndarray      # [N, D]
    val: jnp.ndarray       # [N]
    pos_sig: jnp.ndarray   # [N]
    grad_sig: jnp.ndarray  # [N]


def make_mirror(cap: CapacityParam, dim: int) -> NodeMirror:
    n = cap.max_nodes
    return NodeMirror(
        pos=jnp.zeros((n, dim), jnp.float32),
        grad=jnp.zeros((n, dim), jnp.float32),
        val=jnp.zeros((n,), jnp.float32),
        pos_sig=jnp.zeros((n,), jnp.float32),
        grad_sig=jnp.zeros((n,), jnp.float32))


@jax.jit
def scatter_mirror(mirror: NodeMirror, ids: jnp.ndarray, pos, grad, val,
                   pos_sig, grad_sig) -> NodeMirror:
    """Write the given nodes' current host values (-1 ids dropped)."""
    n = mirror.val.shape[0]
    tgt = jnp.where(ids >= 0, ids, n)

    def scat(old, new):
        ext = jnp.concatenate(
            [old, jnp.zeros((1,) + old.shape[1:], old.dtype)])
        return ext.at[tgt].set(new, mode='drop')[:-1]

    return NodeMirror(pos=scat(mirror.pos, pos),
                      grad=scat(mirror.grad, grad),
                      val=scat(mirror.val, val),
                      pos_sig=scat(mirror.pos_sig, pos_sig),
                      grad_sig=scat(mirror.grad_sig, grad_sig))


@jax.jit
def retrain_cells_from_mirror(store: ClusterStore, mirror: NodeMirror,
                              slots: jnp.ndarray, slot_ok: jnp.ndarray,
                              sup: jnp.ndarray, scale) -> ClusterStore:
    """retrain_cells with the support data gathered ON DEVICE from the
    node mirror — only the [B, mb] int32 support indices travel per
    retrain chunk (~5x less per-frame upload than the five gathered
    arrays; the values are identical by the mirror invariant)."""
    c = jnp.clip(sup, 0, mirror.val.shape[0] - 1)
    valid = sup >= 0
    return retrain_cells(store, slots, slot_ok, mirror.pos[c],
                         mirror.grad[c], mirror.val[c], mirror.pos_sig[c],
                         mirror.grad_sig[c], valid, scale)


@jax.jit
def retrain_cells_from_mirror_with_l(store: ClusterStore,
                                     mirror: NodeMirror,
                                     slots: jnp.ndarray,
                                     slot_ok: jnp.ndarray,
                                     sup: jnp.ndarray, scale):
    """retrain_cells_from_mirror that ALSO returns the fit Cholesky
    factor l [B, (1+d)*mb, (1+d)*mb] — the factor-cache refresh reuses
    it (update_factors_from_l) instead of re-building K and
    re-factorizing (the reference keeps each fit's L, OnGPIS.h)."""
    c = jnp.clip(sup, 0, mirror.val.shape[0] - 1)
    valid = sup >= 0
    return _retrain_impl(store, slots, slot_ok, mirror.pos[c],
                         mirror.grad[c], mirror.val[c], mirror.pos_sig[c],
                         mirror.grad_sig[c], valid, scale)


@functools.partial(jax.jit, static_argnames=("dim", "grid_half"))
def frame_finish_from_mirror(store: ClusterStore, mirror: NodeMirror,
                             ids, pos, grad, val, pos_sig, grad_sig,
                             slots, slot_ok, sup, scale,
                             cell_coords, cell_slots, dim: int,
                             grid_half: int):
    """ONE-dispatch frame epilogue: mirror scatter + retrain-from-mirror
    + device grid rebuild.

    Identical semantics to the three separate dispatches (scatter_mirror
    -> retrain_cells_from_mirror -> build_grid_device); fused so the frame
    pays one dispatch and one upload batch instead of three for
    microsecond-scale work. Returns (store, mirror, grid).
    """
    mirror = scatter_mirror(mirror, ids, pos, grad, val, pos_sig,
                            grad_sig)
    store, l = retrain_cells_from_mirror_with_l(store, mirror, slots,
                                                slot_ok, sup, scale)
    grid = build_grid_device(cell_coords, cell_slots, dim, grid_half)
    return store, mirror, grid, l


@functools.partial(jax.jit,
                   static_argnames=("dim", "grid_half", "noff", "k_cap",
                                    "nbr_dense", "with_factors",
                                    "with_nbrs"),
                   donate_argnums=(14,))
def frame_finish_full(store: ClusterStore, mirror: NodeMirror,
                      ids, pos, grad, val, pos_sig, grad_sig,
                      slots, slot_ok, sup, scale,
                      cell_coords, cell_slots, linv_buf, uniq,
                      dim: int, grid_half: int, noff: int, k_cap: int,
                      nbr_dense: bool, with_factors: bool,
                      with_nbrs: bool):
    """frame_finish_from_mirror EXTENDED with the two test-path upkeep
    stages that used to be separate dispatches: the factor-cache refresh from the fit's own L
    (update_factors_from_l; valid only when the caller verified the live
    slot set is unchanged) and the candidate-table rebuild
    (build_neighbor_table on the POST-retrain `trained`).

    One program, one upload, one dispatch instead of three. Exactly
    equivalent to the separate calls (gated in tests/test_factors.py /
    test_nbrs.py fused-epilogue tests).

    linv_buf is DONATED (scatter in place; 2.1 GB at 3D shapes). When
    with_factors is False, pass a dummy [1, 1, 1] buffer. Returns
    (store, mirror, grid, l, nbrs | None, linv_buf | None).
    """
    mirror = scatter_mirror(mirror, ids, pos, grad, val, pos_sig,
                            grad_sig)
    store, l = retrain_cells_from_mirror_with_l(store, mirror, slots,
                                                slot_ok, sup, scale)
    grid = build_grid_device(cell_coords, cell_slots, dim, grid_half)
    nbrs = None
    if with_nbrs:
        nbrs = build_neighbor_table(cell_coords, cell_slots, store.trained,
                                    grid_half, noff, k_cap, nbr_dense)
    if with_factors:
        linv_buf = _update_factors_from_l_impl(linv_buf, uniq, slots, l,
                                               dim)
    else:
        linv_buf = None
    return store, mirror, grid, l, nbrs, linv_buf


def clear_slots(store: ClusterStore, slots: jnp.ndarray,
                slot_ok: jnp.ndarray) -> ClusterStore:
    """Mark slots untrained (cells pruned by the index)."""
    c = store.trained.shape[0]
    tgt = jnp.where(slot_ok, slots, c)
    ext = jnp.concatenate([store.trained, jnp.zeros((1,), bool)])
    trained = ext.at[tgt].set(False, mode='drop')[:-1]
    return store._replace(trained=trained)


def _factorize_cells(store: ClusterStore, slots: jnp.ndarray, scale,
                     chunk: int = 128,
                     vma_axes: tuple = ()) -> jnp.ndarray:
    """L^-1 for the given slots, chunked: [S, M', M'].

    Each active cell is factorized exactly ONCE per test call (the
    persistent store keeps no factors; see ClusterStore). slots may
    contain out-of-range fill entries — they produce identity factors.
    """
    from ..ops.gp import _chol, linv_from_chol, ongpis_prepare

    s = slots.shape[0]
    pad = (-s) % chunk
    sl = jnp.concatenate([slots, jnp.full((pad,), -1, slots.dtype)])
    sl = sl.reshape(-1, chunk)

    mp_ = store.alpha.shape[-1]

    def compute(slc):
        sc = jnp.clip(slc, 0, store.x.shape[0] - 1)
        xs = store.x[sc]
        vl = store.valid[sc] & (slc >= 0)[:, None]
        gradflag, sigx = ongpis_prepare(store.grad[sc], store.sigx[sc],
                                        store.siggrad[sc], vl)
        k = kernels.matern32_deriv_train_cov(xs, sigx, store.siggrad[sc],
                                             gradflag, vl, scale)
        return linv_from_chol(_chol(k))

    def one(slc):
        def idem(_):
            out = jnp.broadcast_to(jnp.eye(mp_, dtype=store.x.dtype),
                                   (chunk, mp_, mp_))
            if vma_axes:  # match compute's device-varying type (shard_map)
                out = jax.lax.pcast(out, vma_axes, to='varying')
            return out

        return jax.lax.cond(jnp.any(slc >= 0), compute, idem, slc)

    linv = jax.lax.map(one, sl)
    mp = store.alpha.shape[-1]
    return linv.reshape(-1, mp, mp)[:s]


def _ongpis_eval_tile(store: ClusterStore, linv_buf: jnp.ndarray,
                      slot_of: jnp.ndarray, segs: jnp.ndarray,
                      q: jnp.ndarray, scale: float, val_const: float,
                      grad_const: float):
    """Evaluate tiles of queries against their cells' GPs.

    Mean from the cached alpha, variance via the prefactorized L^-1
    (gathered per tile from the transient buffer) — the reference's
    algorithm (OnGPIS.cpp:177-263) with matmuls only in the hot loop.

    segs: [G] COMPACT cell ids (indices into linv_buf / slot_of);
    q: [G, T, D]. Returns (f, grad, varf, vargrad).
    """
    from ..ops.gp import ongpis_prepare

    segc = jnp.clip(segs, 0, linv_buf.shape[0] - 1)
    sc = jnp.clip(slot_of[segc], 0, store.x.shape[0] - 1)
    xs = store.x[sc]
    vl = store.valid[sc]
    al = store.alpha[sc]
    li = linv_buf[segc]
    gradflag, _ = ongpis_prepare(store.grad[sc], store.sigx[sc],
                                 store.siggrad[sc], vl)

    d = xs.shape[-1]
    t = q.shape[-2]
    ks = kernels.matern32_deriv_cross_cov(xs, gradflag, vl, q, scale)
    res = precision.einsum('gmq,gm->gq', ks, al)
    f = res[..., :t]
    grad = jnp.stack([res[..., (1 + i) * t:(2 + i) * t] for i in range(d)],
                     axis=-1)
    v = precision.einsum('gmn,gnq->gmq', li, ks)
    vs = jnp.sum(v * v, axis=-2)
    varf = val_const - vs[..., :t]
    vargrad = jnp.stack(
        [grad_const - vs[..., (1 + i) * t:(2 + i) * t] for i in range(d)],
        axis=-1)
    return f, grad, varf, vargrad


def _grid_candidates(grid: jnp.ndarray, q: jnp.ndarray, cell_size: float,
                     grid_half: int, noff: int, search_half: float,
                     trained: jnp.ndarray):
    """Per query: cluster-cell candidates within the search box.

    grid: dense [(2*grid_half)^D] slot map (slot or -1), row-major over
    integer cell coords k + grid_half where cell center = (k + 0.5)*cell_size.
    Returns (slots [Q, K], sqd [Q, K], ok [Q, K]) with K = (2*noff+1)^D.
    """
    d = q.shape[-1]
    k0 = jnp.floor(q / cell_size).astype(jnp.int32)          # [Q, D]
    offs = jnp.stack(jnp.meshgrid(
        *([jnp.arange(-noff, noff + 1)] * d), indexing='ij'),
        axis=-1).reshape(-1, d)                               # [K, D]
    kc = k0[:, None, :] + offs[None, :, :]                    # [Q, K, D]
    centers = (kc.astype(q.dtype) + 0.5) * cell_size
    inb = jnp.all((kc >= -grid_half) & (kc < grid_half), axis=-1)
    gidx = kc + grid_half
    # row-major flatten
    flat = gidx[..., 0]
    side = 2 * grid_half
    for a in range(1, d):
        flat = flat * side + gidx[..., a]
    flat = jnp.where(inb, flat, 0)
    slots = jnp.where(inb, grid.reshape(-1)[flat], -1)        # [Q, K]
    diff = centers - q[:, None, :]
    sqd = jnp.sum(diff * diff, axis=-1)
    # AABB intersect (non-strict, quadtree.h:100-105): box half =
    # search_half, cell half = cell_size/2
    reach = search_half + cell_size * 0.5
    inter = jnp.all(jnp.abs(diff) <= reach, axis=-1)
    ok = (slots >= 0) & inter & trained[jnp.clip(slots, 0)] & inb
    return slots, sqd, ok


class NeighborTable(NamedTuple):
    """Per-grid-cell candidate lists — the row-gather replacement for the
    dense-grid window gather in _grid_candidates.

    The window gather reads (2*noff+1)^D SCALAR grid entries per query;
    precomputing each cell's present candidates turns that into ONE
    contiguous row gather per query. Entry order within a row is the window-offset
    enumeration order, so the downstream 3-argmin tie-breaks are
    IDENTICAL to the window path (relative order of present candidates
    is preserved). `trained` is baked in at build time — rebuild after
    every retrain (the mapper caches this next to the factor cache).

    keys:  [T] sorted flat grid ids (int32-max padded); for the dense
           variant T == G and keys is arange (row = flat id, no search)
    packed: [T, K] candidate entries, slot * W2 + window_rank (-1 empty)
           where W2 = next pow2 of the window size (2*noff+1)^D. The
           candidate's integer cell coord is NOT stored: it is
           query_cell + window_offset[window_rank], recovered
           arithmetically at query time (same integer sum the build
           used, so the derived centers are bit-identical). Packing
           halves the per-query gather traffic vs separate slot+coord
           tables (the candidates stage was gather-bound).
    n_overflow: [] int32 — candidates dropped because a cell had more
           than K trained neighbors (never silent)
    """

    keys: jnp.ndarray
    packed: jnp.ndarray
    n_overflow: jnp.ndarray


def _rank_to_offset(rank: jnp.ndarray, noff: int, d: int) -> jnp.ndarray:
    """Window rank (ij enumeration of (-noff..noff)^D) -> offset [..., D].

    Pure integer div/mod by compile-time constants — no table gather."""
    side = 2 * noff + 1
    outs = []
    for a in range(d):
        digit = (rank // (side ** (d - 1 - a))) % side
        outs.append(digit - noff)
    return jnp.stack(outs, axis=-1)


@functools.partial(jax.jit, static_argnames=("grid_half", "noff", "k_cap",
                                             "dense"))
def build_neighbor_table(coords: jnp.ndarray, slots: jnp.ndarray,
                         trained: jnp.ndarray, grid_half: int, noff: int,
                         k_cap: int, dense: bool) -> NeighborTable:
    """Build the candidate table from the live cell list.

    coords: [C, D] integer cell coords (padded rows have slots == -1);
    slots: [C]; trained: [max_cells] bool. Each live+trained cell c is
    registered into every grid cell g of its (2*noff+1)^D window, at the
    rank of the offset d = coords[c] - g in the window enumeration
    (exactly _grid_candidates' candidate order).
    """
    c, d = coords.shape
    side = 2 * grid_half
    offs = jnp.stack(jnp.meshgrid(
        *([jnp.arange(-noff, noff + 1)] * d), indexing='ij'),
        axis=-1).reshape(-1, d).astype(jnp.int32)          # [W, D]
    w = offs.shape[0]
    # cell c contributes to g = coord + o at window offset
    # dq = coord - g = -o; the ij enumeration is symmetric under
    # negation-with-index-reversal, so rank(dq) = W - 1 - rank(o)
    o_rank = (w - 1 - jnp.arange(w, dtype=jnp.int32))[None, :]  # [1, W]
    gc = coords[:, None, :] + offs[None]                    # [C, W, D]
    gidx = gc + grid_half
    inb = jnp.all((gidx >= 0) & (gidx < side), axis=-1)     # [C, W]
    gflat = gidx[..., 0]
    for a in range(1, d):
        gflat = gflat * side + gidx[..., a]
    live = (slots >= 0) & trained[jnp.clip(slots, 0, trained.shape[0] - 1)]
    valid = live[:, None] & inb                             # [C, W]

    big = jnp.iinfo(jnp.int32).max
    key = jnp.where(valid, gflat * w + o_rank, big).reshape(-1)
    order = jnp.argsort(key)
    skey = key[order]
    sg = jnp.where(skey < big, skey // w, big)              # flat ids
    w2 = 1 << (w - 1).bit_length()
    # packed entries are slot * W2 + rank in int32: static capacity guard
    # (max_cells 4096, W2 <= 64 -> 2^18; fires only on absurd configs)
    assert trained.shape[0] * w2 < 2 ** 31, "slot*W2 overflows int32"
    e_packed = (slots[:, None] * w2 + o_rank).reshape(-1)[order]

    n = c * w
    if dense:
        t = side ** d
        row = jnp.where(sg < big, sg, t).astype(jnp.int32)
        keys = jnp.arange(t, dtype=jnp.int32)
        counts = jnp.bincount(jnp.clip(row, 0, t), length=t + 1)[:t]
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(n) - starts[jnp.clip(row, 0, t - 1)]
    else:
        t = n
        keys = jnp.where(sg < big, sg, big)
        uniq = jnp.unique(keys, size=t, fill_value=big)
        row = jnp.clip(jnp.searchsorted(uniq, sg), 0, t - 1)
        row = jnp.where(sg < big, row, t).astype(jnp.int32)
        counts = jnp.bincount(jnp.clip(row, 0, t), length=t + 1)[:t]
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(n) - starts[jnp.clip(row, 0, t - 1)]
        keys = uniq
    keep = (sg < big) & (rank < k_cap)
    n_overflow = jnp.sum((sg < big) & ~keep).astype(jnp.int32)
    tgt = jnp.where(keep, row * k_cap + rank, t * k_cap)

    ptbl = jnp.full((t * k_cap + 1,), -1, jnp.int32)
    ptbl = ptbl.at[tgt].set(e_packed, mode='drop')
    ptbl = ptbl[:-1].reshape(t, k_cap)
    return NeighborTable(keys=keys, packed=ptbl, n_overflow=n_overflow)


def _table_candidates(nbrs: NeighborTable, q: jnp.ndarray, cell_size,
                      grid_half: int, noff: int, search_half,
                      dense: bool):
    """_grid_candidates from the precomputed table: one row gather per
    query; identical (slots, sqd, ok) semantics and candidate order
    (trained is baked into the table). Candidate cell coords are
    recovered from the packed window rank (query cell + offset — the
    same integer sum the build keyed on, so centers are bit-identical
    to the stored-coord formulation)."""
    d = q.shape[-1]
    side = 2 * grid_half
    t, k_cap = nbrs.packed.shape[:2]
    w = (2 * noff + 1) ** d
    w2 = 1 << (w - 1).bit_length()
    k0 = jnp.floor(q / cell_size).astype(jnp.int32)
    gidx = k0 + grid_half
    inb = jnp.all((gidx >= 0) & (gidx < side), axis=-1)
    gflat = gidx[..., 0]
    for a in range(1, d):
        gflat = gflat * side + gidx[..., a]
    gflat = jnp.where(inb, gflat, 0)
    if dense:
        row = gflat
        hit = inb
    else:
        big = jnp.iinfo(jnp.int32).max
        pos = jnp.clip(jnp.searchsorted(nbrs.keys, gflat), 0, t - 1)
        hit = inb & (nbrs.keys[pos] == gflat)
        row = pos
    rowc = jnp.clip(row, 0, t - 1)
    packed = nbrs.packed[rowc]                              # [Q, K] row
    slots = packed >> (w2.bit_length() - 1)
    coords = k0[:, None, :] + _rank_to_offset(packed & (w2 - 1), noff, d)
    centers = (coords.astype(q.dtype) + 0.5) * cell_size
    diff = centers - q[:, None, :]
    sqd = jnp.sum(diff * diff, axis=-1)
    reach = search_half + cell_size * 0.5
    inter = jnp.all(jnp.abs(diff) <= reach, axis=-1)
    ok = (slots >= 0) & inter & hit[:, None]
    return slots, sqd, ok


def _candidates_top3(nbrs: NeighborTable, q: jnp.ndarray, cell_size,
                     grid_half: int, noff: int, search_half,
                     dense: bool):
    """_table_candidates + 3-nearest selection fused, in a transposed
    [K, Q] layout.

    Bit-identical outputs to the two-stage path (same comparisons, same
    first-lowest-index argmin tie order — verified in-suite): the 3-pass
    argmin re-reads the [Q, K] rows repeatedly; transposing puts Q on the
    fast axis so every reduction runs in parallel across queries.

    Returns (top_slot [Q, 3], top_ok [Q, 3], n_cand [Q]) — exactly the
    selection map_test consumes downstream.
    """
    d = q.shape[-1]
    side = 2 * grid_half
    t, k_cap = nbrs.packed.shape[:2]
    w = (2 * noff + 1) ** d
    w2 = 1 << (w - 1).bit_length()
    k0 = jnp.floor(q / cell_size).astype(jnp.int32)
    gidx = k0 + grid_half
    inb = jnp.all((gidx >= 0) & (gidx < side), axis=-1)
    gflat = gidx[..., 0]
    for a in range(1, d):
        gflat = gflat * side + gidx[..., a]
    gflat = jnp.where(inb, gflat, 0)
    if dense:
        row = gflat
        hit = inb
    else:
        big = jnp.iinfo(jnp.int32).max
        pos = jnp.clip(jnp.searchsorted(nbrs.keys, gflat), 0, t - 1)
        hit = inb & (nbrs.keys[pos] == gflat)
        row = pos
    rowc = jnp.clip(row, 0, t - 1)
    packed_t = nbrs.packed[rowc].T                    # [K, Q] ONE gather
    slots_t = packed_t >> (w2.bit_length() - 1)
    off_t = jnp.moveaxis(
        _rank_to_offset(packed_t & (w2 - 1), noff, d), -1, 1)  # [K, D, Q]
    coord_t = k0.T[None] + off_t                      # [K, D, Q]
    centers_t = (coord_t.astype(q.dtype) + 0.5) * cell_size
    diff_t = centers_t - q.T[None]                    # [K, D, Q]
    sqd_t = jnp.sum(diff_t * diff_t, axis=1)          # [K, Q]
    reach = search_half + cell_size * 0.5
    inter_t = jnp.all(jnp.abs(diff_t) <= reach, axis=1)
    ok_t = (slots_t >= 0) & inter_t & hit[None, :]
    n_cand = jnp.sum(ok_t, axis=0)

    cur = jnp.where(ok_t, sqd_t, jnp.inf)
    iota_k = jnp.arange(k_cap, dtype=jnp.int32)[:, None]
    oki = ok_t.astype(jnp.int32)
    tops_slot, tops_ok = [], []
    for r in range(3):
        i = jnp.argmin(cur, axis=0)                   # first-min ties
        sel = iota_k == i[None, :]
        tops_slot.append(jnp.sum(jnp.where(sel, slots_t, 0), axis=0))
        tops_ok.append(jnp.sum(jnp.where(sel, oki, 0), axis=0) > 0)
        if r < 2:
            cur = jnp.where(sel, jnp.inf, cur)
    top_slot = jnp.stack(tops_slot, axis=-1)
    top_ok = (jnp.stack(tops_ok, axis=-1)
              & (jnp.arange(3)[None, :] < n_cand[:, None]))
    return top_slot.astype(jnp.int32), top_ok, n_cand


@functools.partial(jax.jit, static_argnames=("max_active",))
def factorize_slots(store: ClusterStore, slots: jnp.ndarray, scale,
                    max_active: int):
    """Public factor precomputation for a slot set (padded with -1).

    The reference keeps each cell's Cholesky factor alive between updates
    (OnGPIS.h `L`); this is the equivalent bounded cache fill. Returns
    (linv_buf [S, M', M'], slot_of [S] sorted ascending with int32-max
    sentinels for padding).
    """
    big = jnp.iinfo(jnp.int32).max
    sl = jnp.where(slots >= 0, slots, big).astype(jnp.int32)
    sl = jnp.sort(sl)[:max_active]
    slot_of = jnp.where(sl < big, sl, -1)
    return _factorize_cells(store, slot_of, scale), jnp.where(
        slot_of >= 0, slot_of, big)


def refresh_bucket(mb, m: int, d: int):
    """Smallest support-row count >= mb whose padded system size
    (1+d)*mb is a multiple of 128; None when only the full capacity
    qualifies (then the bucketed refresh has nothing to save)."""
    import math
    if mb is None:
        return None
    step = 128 // math.gcd(1 + d, 128)      # d=3 -> 32; d=2 -> 128
    mb2 = ((int(mb) + step - 1) // step) * step
    return mb2 if 0 < mb2 < m else None


def _factorize_cells_bucketed(store: ClusterStore, slots: jnp.ndarray,
                              scale, mb: int) -> jnp.ndarray:
    """L^-1 for slots whose valid support lies in rows [:mb], computed at
    the SMALL size and embedded into the full-M' layout.

    Masked identity-row padding makes this mathematically exact: padded
    rows of the train covariance are e_i, so the Cholesky recursion
    leaves them as identity rows/cols — L^-1 of the full system IS the
    small L^-1 scattered at the real-row positions (same argument as
    the size-bucketed retrain, retrain_cells). Numerically the two
    sizes reassociate reductions differently, so entries agree to f32
    rounding (measured <=1e-6 abs), not bitwise. Cost: (mb/M)^3 of the
    full factorization FLOPs and half its sequential block depth.
    """
    from ..ops.gp import _chol, linv_from_chol, ongpis_prepare

    m = store.x.shape[1]
    d = store.x.shape[-1]
    mp = store.alpha.shape[-1]
    sc = jnp.clip(slots, 0, store.x.shape[0] - 1)
    xs = store.x[sc][:, :mb]
    vl = store.valid[sc][:, :mb] & (slots >= 0)[:, None]
    gradflag, sigx = ongpis_prepare(store.grad[sc][:, :mb],
                                    store.sigx[sc][:, :mb],
                                    store.siggrad[sc][:, :mb], vl)
    k = kernels.matern32_deriv_train_cov(xs, sigx,
                                         store.siggrad[sc][:, :mb],
                                         gradflag, vl, scale)
    linv_s = linv_from_chol(_chol(k))       # [B, (1+d)mb, (1+d)mb]
    idx = jnp.concatenate(
        [b * m + jnp.arange(mb, dtype=jnp.int32) for b in range(1 + d)])
    full = jnp.broadcast_to(jnp.eye(mp, dtype=linv_s.dtype),
                            (slots.shape[0], mp, mp))
    return full.at[:, idx[:, None], idx[None, :]].set(linv_s)


@functools.partial(jax.jit, static_argnames=("mb",),
                   donate_argnums=(1,))
def update_factors(store: ClusterStore, linv_buf: jnp.ndarray,
                   uniq: jnp.ndarray, slots: jnp.ndarray,
                   scale, mb=None) -> jnp.ndarray:
    """Incremental twin of factorize_slots: refresh L^-1 for the given
    (just-retrained) slots inside an existing factor buffer.

    The reference retrains a cell's GP and keeps its fresh L alive
    (OnGPIS.h `L`, swapped in by Update, quadtree.cpp:438-441); this is
    the batched equivalent — only the B touched cells re-factorize
    instead of the whole live set.

    slots: [B], -1-padded. Callers must verify the live slot set is
    unchanged (every real slot already present in uniq) before taking
    this path; slots that miss uniq are dropped here as a backstop.

    mb (static): when the retrain fitted every refreshed cell at a
    support bucket <= mb rows, pass it (via refresh_bucket) to
    factorize at the small size and embed — equal to f32 rounding,
    (mb/M)^3 the FLOPs.
    """
    big = jnp.iinfo(jnp.int32).max
    max_active = linv_buf.shape[0]
    sl = jnp.where(slots >= 0, slots, big).astype(jnp.int32)
    pos = jnp.clip(jnp.searchsorted(uniq, sl), 0, max_active - 1)
    hit = (sl < big) & (uniq[pos] == sl)
    keep = jnp.where(hit, slots, -1).astype(jnp.int32)
    if mb is not None and mb < store.x.shape[1]:
        new_linv = _factorize_cells_bucketed(store, keep, scale, mb)
    else:
        new_linv = _factorize_cells(store, keep, scale,
                                    chunk=min(128, slots.shape[0]))
    # out-of-range targets (misses) drop directly — no extended-row copy
    # of the multi-GB buffer (mode='drop' discards OOB updates)
    tgt = jnp.where(hit, pos, max_active)
    return linv_buf.at[tgt].set(new_linv, mode='drop')


def _embed_linv(linv_s: jnp.ndarray, mp: int, d: int) -> jnp.ndarray:
    """Scatter a small-system L^-1 [B, (1+d)mb, (1+d)mb] into the
    identity-padded full layout [B, mp, mp] (see
    _factorize_cells_bucketed for why this is exact)."""
    mp_s = linv_s.shape[-1]
    if mp_s == mp:
        return linv_s
    m = mp // (1 + d)
    mb = mp_s // (1 + d)
    idx = jnp.concatenate(
        [b * m + jnp.arange(mb, dtype=jnp.int32) for b in range(1 + d)])
    full = jnp.broadcast_to(jnp.eye(mp, dtype=linv_s.dtype),
                            (linv_s.shape[0], mp, mp))
    return full.at[:, idx[:, None], idx[None, :]].set(linv_s)


def _update_factors_from_l_impl(linv_buf, uniq, slots, l, d):
    """Trace-level body of update_factors_from_l (also inlined by
    frame_finish_full, where the DONATION lives on the outer program)."""
    from ..ops.gp import linv_from_chol

    big = jnp.iinfo(jnp.int32).max
    max_active = linv_buf.shape[0]
    sl = jnp.where(slots >= 0, slots, big).astype(jnp.int32)
    pos = jnp.clip(jnp.searchsorted(uniq, sl), 0, max_active - 1)
    hit = (sl < big) & (uniq[pos] == sl)
    linv_full = _embed_linv(linv_from_chol(l), linv_buf.shape[-1], d)
    tgt = jnp.where(hit, pos, max_active)
    return linv_buf.at[tgt].set(linv_full, mode='drop')


@functools.partial(jax.jit, static_argnames=("d",),
                   donate_argnums=(0,))
def update_factors_from_l(linv_buf: jnp.ndarray, uniq: jnp.ndarray,
                          slots: jnp.ndarray, l: jnp.ndarray,
                          d: int) -> jnp.ndarray:
    """Factor-cache refresh from the retrain fit's OWN Cholesky factor.

    The fit already factorized each refreshed cell's train covariance
    (fit_ongpis returns l; retrain_cells_from_mirror_with_l /
    frame_finish_from_mirror surface it) — exactly the reference's
    architecture, which keeps each fit's `L` alive (OnGPIS.h). Only the
    triangular inverse remains here; update_factors also rebuilds K and
    re-factorizes it.

    slots: [B] aligned row-for-row with l; slots missing from uniq are
    dropped. l may be at a support bucket (system size (1+d)*mb) — the
    inverse computes at the small size and embeds (exact; see
    _factorize_cells_bucketed). linv_buf is DONATED: the in-place
    scatter skips a 2.1 GB buffer copy at the 3D shapes (callers always
    discard the old buffer — api._refresh_factors).
    """
    return _update_factors_from_l_impl(linv_buf, uniq, slots, l, d)


class TestInfo(NamedTuple):
    """Per-call observability counters returned by map_test.

    n_dropped: (query, rank) evaluations whose cell fell outside the
        factor buffer (max_active overflow / factor-cache miss) — the
        test-path twin of the index's `overflow_support` counter.
    n_pairs: (query, rank) pairs actually evaluated through the tile
        plans (the FLOP-proportional work measure; the two-phase path
        shows up here as ~Q + 2*n_phase2 instead of 3Q).
    n_phase2: queries whose nearest cell was uncertain and went through
        the rank-1/2 phase (0 on the single-phase path).
    """

    n_dropped: jnp.ndarray
    n_pairs: jnp.ndarray
    n_phase2: jnp.ndarray


def _eval_pairs(store: ClusterStore, linv_buf: jnp.ndarray,
                slot_of: jnp.ndarray, plan: segmented.TilePlan,
                npair: int,
                q: jnp.ndarray, div: int, scale, val_const, grad_const,
                tile: int, max_active: int,
                vma_axes: tuple, remat: bool = False,
                flat_eval: bool = False):
    """Evaluate one planned pair set against the factor buffer.

    plan: single-cell tile schedule over npair pairs (built by
    segmented.plan_tiles_for_slots); pair p belongs to query p // div.
    Returns (f [P], g [P, D], vf [P] (inf where not evaluated),
    vg [P, D]).

    flat_eval evaluates ALL tiles in one batched op instead of the
    chunked lax.scan — a much simpler program whose transpose is plain
    einsums (no scan/cond to differentiate through); the right choice
    for small differentiable evaluations (render.implicit_correct).
    Costs compute on the static padding tiles, so keep it off for the
    big forward query batches.
    """
    d = q.shape[-1]

    if flat_eval:
        qt = q[jnp.clip(plan.pair_ids, 0) // div]       # [NT, T, D]
        f_t, g_t, vf_t, vg_t = _ongpis_eval_tile(
            store, linv_buf, slot_of, plan.tile_seg, qt, scale,
            val_const, grad_const)
        mask = (plan.pair_ids >= 0) & (plan.tile_seg[:, None] >= 0)
        tgt = jnp.where(mask, plan.pair_ids, npair).reshape(-1)

        def scat(init, val):
            ext = jnp.concatenate(
                [init, jnp.zeros((1,) + init.shape[1:], init.dtype)])
            flat = val.reshape((-1,) + val.shape[2:])
            return ext.at[tgt].set(flat, mode='drop')[:-1]

        f_p = scat(jnp.zeros((npair,), q.dtype), f_t)
        vf_p = scat(jnp.full((npair,), jnp.inf, q.dtype), vf_t)
        g_p = scat(jnp.zeros((npair, d), q.dtype), g_t)
        vg_p = scat(jnp.zeros((npair, d), q.dtype), vg_t)
        return f_p, g_p, vf_p, vg_p

    def eval_tile(segs, pids):
        qt = q[jnp.clip(pids, 0) // div]                      # [G, T, D]
        return _ongpis_eval_tile(store, linv_buf, slot_of, segs, qt,
                                 scale, val_const, grad_const)

    out0 = (jnp.zeros((npair,), q.dtype),
            jnp.zeros((npair, d), q.dtype),
            jnp.full((npair,), jnp.inf, q.dtype),
            jnp.zeros((npair, d), q.dtype))
    return segmented.segmented_eval(
        plan, eval_tile, out0, vma_axes=vma_axes, remat=remat)


@functools.partial(
    jax.jit,
    static_argnames=("grid_half", "noff", "tile", "max_cells",
                     "max_active", "vma_axes", "nbr_dense",
                     "two_phase", "remat", "flat_eval"))
def map_test(store: ClusterStore, grid: jnp.ndarray, q: jnp.ndarray,
             cell_size, grid_half: int, noff: int,
             search_half, scale, val_const,
             grad_const, var_thre, default_var,
             tile: int, max_cells: int, max_active: int = 512,
             factors=None,
             vma_axes: tuple = (), nbrs=None, nbr_dense: bool = False,
             two_phase: bool = False, remat: bool = False,
             flat_eval: bool = False):
    """Batched SDF+gradient+variance query.

    Parity: GPisMap.cpp:665-763 (2D; var_thre 0.4) and
    GPisMap3.cpp:794-902 (3D; 0.5). Per query: collect non-empty
    cluster cells intersecting the search box, evaluate the nearest cell's
    GP, fall back to the up-to-3 nearest with variance-weighted blending of
    the best two when the nearest is uncertain.

    two_phase=True evaluates like the reference's control flow: rank-0
    pairs first, then ONLY the uncertain queries' rank-1/2 pairs (the
    `var > thre` gate, GPisMap.cpp:706-722); outputs are bit-identical
    to the single-phase path because the selection below never reads
    rank-1/2 results of confident queries. Single-phase is the default;
    two_phase stays as the equivalence-tested alternative (it pays a
    second plan to skip evaluation work, so it wins only where
    evaluation dominates planning).

    max_active bounds the number of DISTINCT cluster cells one query batch
    may touch (each is Cholesky-factorized once into a transient buffer);
    overflowing cells are dropped from blending.

    Returns (f [Q], grad [Q, D], varf [Q], vargrad [Q, D],
    info TestInfo). On the two-phase path pairs intentionally skipped
    (confident queries' ranks 1-2) are NOT counted in info.n_dropped.
    """
    nq, d = q.shape
    if nbrs is not None:
        # precomputed candidate rows + 3-nearest selection in ONE
        # transposed pass (identical semantics and order)
        top_slot, top_ok, n_cand = _candidates_top3(
            nbrs, q, cell_size, grid_half, noff, search_half, nbr_dense)
    else:
        slots, sqd, ok = _grid_candidates(grid, q, cell_size, grid_half,
                                          noff, search_half,
                                          store.trained)
        n_cand = jnp.sum(ok, axis=-1)
        # 3 nearest candidates by center distance (GPisMap.cpp:695-698).
        # Three masked argmin passes instead of lax.top_k: top_k sorts
        # the whole K-wide candidate row per query; argmin is a cheap
        # reduction with identical tie semantics (first lowest index).
        sqd_m = jnp.where(ok, sqd, jnp.inf)
        kw = sqd_m.shape[-1]
        cols = jnp.arange(kw, dtype=jnp.int32)
        cur = sqd_m
        tops = []
        for _ in range(3):
            i = jnp.argmin(cur, axis=-1).astype(jnp.int32)
            tops.append(i)
            cur = jnp.where(cols[None, :] == i[:, None], jnp.inf, cur)
        top_idx = jnp.stack(tops, axis=-1)                    # [Q, 3]
        top_slot = jnp.take_along_axis(slots, top_idx, axis=-1)
        top_ok = jnp.take_along_axis(ok, top_idx, axis=-1)
        top_ok = top_ok & (jnp.arange(3)[None, :] < n_cand[:, None])

    # pair list: (query, rank) -> cell; pair p belongs to query p // 3
    seg3 = jnp.where(top_ok, top_slot, -1)                    # [Q, 3]

    # compact the touched slots; factorize each exactly once — or reuse a
    # prefactorized cache (factors = (linv_buf, uniq_sorted)) filled by
    # factorize_slots, the analogue of the reference's per-cell stored L
    big = jnp.iinfo(jnp.int32).max
    if factors is None:
        seg_for_uniq = jnp.where(seg3 >= 0, seg3, big).reshape(-1)
        uniq = jnp.unique(seg_for_uniq, size=max_active, fill_value=big)
        slot_of = jnp.where(uniq < big, uniq, -1).astype(jnp.int32)
        linv_buf = _factorize_cells(store, slot_of, scale,
                                    vma_axes=vma_axes)
    else:
        linv_buf, uniq = factors
        slot_of = jnp.where(uniq < big, uniq, -1).astype(jnp.int32)

    def plan_for(seg):
        """[P] raw slot ids -> (tile plan, n_dropped, n_in_plan): the
        plan is built DIRECTLY in compact-segment space off the sorted
        slot keys (segmented.plan_tiles_for_slots) — no per-pair
        slot->compact gather. Slots absent from uniq (or
        out of [0, max_cells)) are dropped and counted, exactly the old
        compaction's semantics."""
        plan, n_in = segmented.plan_tiles_for_slots(
            seg, uniq, max_cells, max_active, tile)
        n_drop = (jnp.sum(seg >= 0) - n_in).astype(jnp.int32)
        return plan, n_drop, n_in

    run = functools.partial(
        _eval_pairs, store, linv_buf, slot_of, q=q, scale=scale,
        val_const=val_const, grad_const=grad_const, tile=tile,
        max_active=max_active, vma_axes=vma_axes,
        remat=remat, flat_eval=flat_eval)

    if two_phase:
        # ---- phase 1: nearest-cell pairs only ----
        plan1, nd1, np1 = plan_for(seg3[:, 0])
        f0, g0, vf0, vg0 = run(plan=plan1, npair=nq, div=1)
        # the reference's blend gate (GPisMap.cpp:706): ranks 1-2 are
        # only consulted when the nearest evaluation is uncertain. An
        # unevaluated/dropped rank-0 (vf0 == inf) counts as uncertain.
        vf0m = jnp.where(top_ok[:, 0], vf0, jnp.inf)
        uncertain = (n_cand >= 2) & ~(vf0m <= var_thre)
        n_phase2 = jnp.sum(uncertain).astype(jnp.int32)
        # ---- phase 2: ranks 1-2 of uncertain queries ----
        seg12 = jnp.where(uncertain[:, None], seg3[:, 1:], -1)
        plan2, nd2, np2 = plan_for(seg12.reshape(-1))
        f12, g12, vf12, vg12 = run(plan=plan2, npair=2 * nq, div=2)
        f3 = jnp.concatenate([f0[:, None], f12.reshape(nq, 2)], axis=1)
        g3 = jnp.concatenate([g0[:, None], g12.reshape(nq, 2, d)], axis=1)
        vf3 = jnp.concatenate([vf0[:, None], vf12.reshape(nq, 2)], axis=1)
        vg3 = jnp.concatenate([vg0[:, None], vg12.reshape(nq, 2, d)],
                              axis=1)
        vf3 = jnp.where(top_ok, vf3, jnp.inf)
        n_dropped = nd1 + nd2
        n_pairs = (np1 + np2).astype(jnp.int32)
    else:
        plan3, n_dropped, n_pairs = plan_for(seg3.reshape(-1))
        n_phase2 = jnp.zeros((), jnp.int32)
        f_p, g_p, vf_p, vg_p = run(plan=plan3, npair=3 * nq, div=3)
        f3 = f_p.reshape(nq, 3)
        g3 = g_p.reshape(nq, 3, d)
        vf3 = jnp.where(top_ok, vf_p.reshape(nq, 3), jnp.inf)
        vg3 = vg_p.reshape(nq, 3, d)

    # --- selection / blending (GPisMap.cpp:685-758) ---
    deff = jnp.zeros((nq,), q.dtype)
    defg = jnp.zeros((nq, d), q.dtype)
    defvf = jnp.full((nq,), default_var, q.dtype)
    defvg = jnp.zeros((nq, d), q.dtype)

    # two smallest variances of the up-to-3 results (GPisMap.cpp:730-733
    # sorts; only the best two feed the blend). Explicit stable
    # compare-selects instead of argsort + take_along_axis: a 3-wide-axis
    # argsort lowers to a general sort plus four gathers; these wheres
    # fuse into the surrounding elementwise code. Strict < keeps argsort's stable tie order.
    def pick(c, a, b):
        return jnp.where(c[:, None] if a.ndim == 2 else c, a, b)

    v0, v1, v2 = vf3[:, 0], vf3[:, 1], vf3[:, 2]
    b01 = v1 < v0
    lo_v, hi_v = pick(b01, v1, v0), pick(b01, v0, v1)
    c_best = v2 < lo_v            # rank-2 wins outright
    c_sec = v2 < hi_v             # rank-2 is (at least) second
    vb0 = pick(c_best, v2, lo_v)
    vb1 = pick(c_best, lo_v, pick(c_sec, v2, hi_v))

    def best2(x3):
        x0, x1, x2 = x3[:, 0], x3[:, 1], x3[:, 2]
        lo, hi = pick(b01, x1, x0), pick(b01, x0, x1)
        return (pick(c_best, x2, lo),
                pick(c_best, lo, pick(c_sec, x2, hi)))

    fb0, fb1 = best2(f3)
    gb0, gb1 = best2(g3)
    vgb0, vgb1 = best2(vg3)

    # best < thr -> best; else variance-weighted blend of the two best with
    # w1 = var_best - thr, w2 = var_second - thr (GPisMap.cpp:735-756)
    best_lt = vb0 < var_thre
    w1 = vb0 - var_thre
    w2 = jnp.where(jnp.isfinite(vb1), vb1, vb0) - var_thre
    w12 = jnp.where(jnp.abs(w1 + w2) > 0, w1 + w2, 1.0)

    def mix(a_best, a_second):
        sh = (-1,) + (1,) * (a_best.ndim - 1)
        return ((w2.reshape(sh) * a_best + w1.reshape(sh) * a_second)
                / w12.reshape(sh))

    fin1 = jnp.isfinite(vb1)
    f2nd = jnp.where(fin1, fb1, fb0)
    v2nd = jnp.where(fin1, vb1, vb0)
    g2nd = jnp.where(fin1[:, None], gb1, gb0)
    vg2nd = jnp.where(fin1[:, None], vgb1, vgb0)

    f_mix = jnp.where(best_lt, fb0, mix(fb0, f2nd))
    vf_mix = jnp.where(best_lt, vb0, mix(vb0, v2nd))
    g_mix = jnp.where(best_lt[:, None], gb0, mix(gb0, g2nd))
    vg_mix = jnp.where(best_lt[:, None], vgb0, mix(vgb0, vg2nd))

    # single candidate -> nearest result regardless of variance
    # (GPisMap.cpp:686-692); >= 2 -> nearest if confident, else blend path
    use_near = (n_cand == 1) | (vf3[:, 0] <= var_thre)
    none = n_cand == 0

    def sel(near, mixv, defv):
        c_near = use_near.reshape((-1,) + (1,) * (near.ndim - 1))
        c_none = none.reshape((-1,) + (1,) * (near.ndim - 1))
        return jnp.where(c_none, defv, jnp.where(c_near, near, mixv))

    f_out = sel(f3[:, 0], f_mix, deff)
    g_out = sel(g3[:, 0], g_mix, defg)
    vf_out = sel(vf3[:, 0], vf_mix, defvf)
    vg_out = sel(vg3[:, 0], vg_mix, defvg)
    # guard: queries whose results never materialised (inf var)
    bad = ~jnp.isfinite(vf_out)
    vf_out = jnp.where(bad, default_var, vf_out)
    f_out = jnp.where(bad, 0.0, f_out)
    g_out = jnp.where(bad[:, None], 0.0, g_out)
    vg_out = jnp.where(bad[:, None], 0.0, vg_out)
    return f_out, g_out, vf_out, vg_out, TestInfo(
        n_dropped=n_dropped, n_pairs=n_pairs, n_phase2=n_phase2)


@functools.partial(
    jax.jit,
    static_argnames=("grid_half", "noff", "tile", "max_cells",
                     "max_active", "mesh", "nbr_dense",
                     "two_phase"))
def map_test_sharded(store: ClusterStore, grid: jnp.ndarray,
                     q: jnp.ndarray, cell_size, grid_half: int, noff: int,
                     search_half, scale, val_const, grad_const, var_thre,
                     default_var, tile: int, max_cells: int,
                     max_active: int = 512,
                     factors=None, mesh=None, nbrs=None,
                     nbr_dense: bool = False, two_phase: bool = False):
    """map_test with the query batch sharded over a 1-axis mesh.

    shard_map (not sharding propagation) on purpose: each device plans and
    scans its OWN tile schedule over its local query shard — the exact
    SPMD analogue of the reference's per-thread static chunking
    (GPisMap.cpp:765-810). Propagating a global tile plan would make every
    device execute the full global scan with 1/N-sized steps and pay
    cross-device gathers inside it. Store/grid/factors are replicated;
    the forward loop has ZERO cross-device traffic (n_dropped is the one
    psum). q.shape[0] must divide by mesh.size.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    rep = P()
    dat = P(axis)

    def local_fn(store_, grid_, q_, cell_size_, search_half_, scale_,
                 val_const_, grad_const_, var_thre_, default_var_,
                 factors_, nbrs_):
        f, g, vf, vg, info = map_test(
            store_, grid_, q_, cell_size_, grid_half, noff, search_half_,
            scale_, val_const_, grad_const_, var_thre_, default_var_,
            tile, max_cells, max_active, factors_,
            vma_axes=(axis,), nbrs=nbrs_, nbr_dense=nbr_dense,
            two_phase=two_phase)
        # ONE packed psum: a pytree psum lowers to one collective per
        # leaf
        iv = jax.lax.psum(jnp.stack([info.n_dropped, info.n_pairs,
                                     info.n_phase2]), axis)
        return f, g, vf, vg, TestInfo(n_dropped=iv[0], n_pairs=iv[1],
                                      n_phase2=iv[2])

    sc = jnp.float32
    ops = (store, grid, q, jnp.asarray(cell_size, sc),
           jnp.asarray(search_half, sc), jnp.asarray(scale, sc),
           jnp.asarray(val_const, sc), jnp.asarray(grad_const, sc),
           jnp.asarray(var_thre, sc), jnp.asarray(default_var, sc),
           factors, nbrs)
    in_specs = (jax.tree.map(lambda _: rep, store), rep, dat,
                rep, rep, rep, rep, rep, rep, rep,
                jax.tree.map(lambda _: rep, factors),
                jax.tree.map(lambda _: rep, nbrs))
    out_specs = (dat, dat, dat, dat, rep)
    return jax.shard_map(local_fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)(*ops)


@functools.partial(jax.jit, static_argnames=("dim", "grid_half"))
def build_grid_device(coords: jnp.ndarray, slots: jnp.ndarray, dim: int,
                      grid_half: int) -> jnp.ndarray:
    """build_grid computed ON DEVICE from the (padded) live-cell list.

    The host variant materializes the dense [side^D] map and uploads it
    every frame — 262 KB (2D) / 8 MB (3D) per update; here only the
    [C, D] cell list travels. Identical result (cells have
    unique coords, so scatter order is irrelevant); padded rows carry
    slots == -1 and are dropped."""
    side = 2 * grid_half
    k = coords.astype(jnp.int32) + grid_half
    inb = jnp.all((k >= 0) & (k < side), axis=-1)
    flat = k[..., 0]
    for a in range(1, dim):
        flat = flat * side + k[..., a]
    flat = jnp.where(inb & (slots >= 0), flat, side ** dim)
    g = jnp.full((side ** dim + 1,), -1, jnp.int32)
    g = g.at[flat].set(slots.astype(jnp.int32), mode='drop')[:-1]
    return g.reshape((side,) * dim)


def build_grid(cell_coords: np.ndarray, slots: np.ndarray, dim: int,
               grid_half: int) -> jnp.ndarray:
    """Dense cluster grid from host cell tables.

    cell_coords: [C, D] integer coords k (cell center = (k + 0.5)*size);
    slots: [C] slot ids. Cells outside the grid are dropped.
    """
    side = 2 * grid_half
    grid = np.full((side,) * dim, -1, np.int32)
    if len(cell_coords):
        k = cell_coords + grid_half
        inb = np.all((k >= 0) & (k < side), axis=-1)
        grid[tuple(k[inb].T)] = slots[inb]
    return jnp.asarray(grid)
