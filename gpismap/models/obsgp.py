"""Partitioned observation GPs — batched formulation.

The reference trains one tiny OU-kernel GP per overlapping group of scan
samples (1D, reference: cpp/src/ObsGP.cpp:85-187) or per grid cell of a
depth image (2D, ObsGP.cpp:193-463), then per test point linearly scans for
the owning group and evaluates that GP on one thread each.

Here all groups train as ONE batched Cholesky (static [G, M, M] shapes with
validity masks) and all test points evaluate with chunked gathers of a
precomputed per-group K^-1 (pure matmuls; see ops/gp.py:gpou_posterior_gather)
— the moral equivalent of the reference's hardware_concurrency fan-out
(ObsGP.cpp:410-463), but data-parallel on the device instead of 8 CPU threads.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import ObsGPParam
from ..ops import gp, precision

# 1D: group sizes are bounded by group_size + overlap (the "last two groups
# split the remainder in half" rule keeps them <= gs + ov, ObsGP.cpp:113-136).
_PAD_INVALID = 1e6


class ObsGP1DState(NamedTuple):
    """Batched partitioned 1D scan GP (reference: ObsGP.h:81-102)."""

    x: jnp.ndarray          # [G, M, 1] per-group angles
    valid: jnp.ndarray      # [G, M]
    alpha: jnp.ndarray      # [G, M]
    linv: jnp.ndarray       # [G, M, M]
    trained: jnp.ndarray    # [G] bool — group exists (g < n_group)
    bounds: jnp.ndarray     # [G + 1] group boundary angles, +inf padded
    liml: jnp.ndarray       # scalar: bounds[0] + margin
    limr: jnp.ndarray       # scalar: last bound - margin
    any_trained: jnp.ndarray  # scalar bool — nGroup >= 2


def _group_layout(n: jnp.ndarray, gs: int, ov: int, g_max: int, m: int):
    """Start index and size of each group, vectorized.

    Mirrors the partition rule of ObsGP1D::train (ObsGP.cpp:91-136):
    nGroup = n/gs + 1 groups; all but the last two have size gs+ov starting
    at g*gs; the last two split the remainder (rem in [gs, 2gs)) in half
    with ov overlap.
    Returns (start [G], size [G], n_group scalar).
    """
    n_group = n // gs + 1
    g = jnp.arange(g_max)
    rem = n - (n_group - 2) * gs
    start_norm = g * gs
    # second-to-last group: start (nG-2)*gs, size rem//2 + ov + 1
    # last group: start (nG-2)*gs + rem//2, size rem - rem//2
    start = jnp.where(g == n_group - 1,
                      (n_group - 2) * gs + rem // 2, start_norm)
    size = jnp.where(g < n_group - 2, gs + ov,
                     jnp.where(g == n_group - 2, rem // 2 + ov + 1,
                               rem - rem // 2))
    size = jnp.clip(size, 0, m)
    exists = (g < n_group) & (n_group >= 2)
    size = jnp.where(exists, size, 0)
    return start, size, n_group


def fit_obsgp1d(theta: jnp.ndarray, f: jnp.ndarray, valid: jnp.ndarray,
                param: ObsGPParam, g_max: int = 32) -> ObsGP1DState:
    """Train the partitioned 1D observation GP (ObsGP.cpp:85-143).

    theta: [N] beam angles (ascending); f: [N] regression targets
    (1/sqrt(range), GPisMap.cpp:133); valid: [N] range-gate mask.
    Invalid beams are compacted out (stable) before grouping, matching the
    reference's preprocessing (GPisMap.cpp:124-143).
    """
    gs, ov = param.group_size, param.overlap
    m = gs + ov  # max group size (see _group_layout)

    nb = theta.shape[0]
    order = jnp.argsort(~valid, stable=True)      # valid-first, order kept
    theta_c = theta[order]
    f_c = f[order]
    n = jnp.sum(valid).astype(jnp.int32)

    start, size, n_group = _group_layout(n, gs, ov, g_max, m)

    idx = start[:, None] + jnp.arange(m)[None, :]          # [G, M]
    in_group = jnp.arange(m)[None, :] < size[:, None]
    idx_c = jnp.clip(idx, 0, nb - 1)
    gx = theta_c[idx_c][..., None]                          # [G, M, 1]
    gf = f_c[idx_c]

    st = gp.fit_gpou(gx, gf, in_group, param.scale, param.noise)
    linv = gp.linv_from_chol(st.l)

    # boundary angles (ObsGP.cpp:93,102,117,129):
    # bounds[0] = theta[0]; interior g: theta[g*gs + gs + ov/2];
    # for g == nG-2: theta[start + rem//2 + ov - ov//2]  (= i2 - ov/2);
    # last bound: theta[n-1]
    g = jnp.arange(g_max)
    rem = n - (n_group - 2) * gs
    bidx = jnp.where(g < n_group - 2, g * gs + gs + ov - ov // 2,
                     jnp.where(g == n_group - 2,
                               (n_group - 2) * gs + rem // 2 + ov - ov // 2,
                               n - 1))
    bidx = jnp.where(g == n_group - 1, n - 1, bidx)
    bounds_core = theta_c[jnp.clip(bidx, 0, nb - 1)]
    bounds = jnp.concatenate([theta_c[:1], bounds_core])
    bvalid = jnp.arange(g_max + 1) <= n_group
    bounds = jnp.where(bvalid, bounds, jnp.inf)

    liml = bounds[0] + param.margin
    limr = theta_c[jnp.clip(n - 1, 0, nb - 1)] - param.margin
    return ObsGP1DState(
        x=gx, valid=in_group, alpha=st.alpha, linv=linv,
        trained=(g < n_group) & (n_group >= 2) & jnp.any(in_group, -1),
        bounds=bounds, liml=liml, limr=limr,
        any_trained=(n_group >= 2) & (n > 0))


def obsgp1d_test(state: ObsGP1DState, q: jnp.ndarray, param: ObsGPParam,
                 chunk: int = 4096):
    """Posterior at angles q [Q] (reference: ObsGP.cpp:145-187).

    Returns (mean [Q], var [Q]); out-of-range / boundary-coincident queries
    get the 1e6 sentinel (ObsGP.cpp:161).
    """
    # owning group: count of interior boundaries strictly below q
    # (reference walks bounds with strict comparisons, ObsGP.cpp:171-181)
    below = state.bounds[None, 1:] < q[:, None]       # [Q, G]
    gidx = jnp.sum(below, axis=-1).astype(jnp.int32)
    gidx_c = jnp.clip(gidx, 0, state.bounds.shape[0] - 2)
    lo = state.bounds[gidx_c]
    hi = state.bounds[gidx_c + 1]
    in_margin = (q >= state.liml) & (q <= state.limr)
    strict = (q > lo) & (q < hi)
    ok = in_margin & strict & state.any_trained

    mean, var = gp.gpou_posterior_gather(
        state.x, state.alpha, state.linv, state.valid, state.trained,
        gidx_c, q[:, None], param.scale, param.noise, chunk)
    mean = jnp.where(ok, mean, 0.0)
    var = jnp.where(ok, var, _PAD_INVALID)
    return mean, var


class ObsGP2DState(NamedTuple):
    """Batched partitioned 2D depth-grid GP (reference: ObsGP.h:105-148)."""

    x: jnp.ndarray         # [C, M, 2] per-cell (v, u) inputs
    valid: jnp.ndarray     # [C, M]
    alpha: jnp.ndarray     # [C, M]
    linv: jnp.ndarray      # [C, M, M]
    trained: jnp.ndarray   # [C]
    val_i: jnp.ndarray     # [nG0 + 1] v boundaries
    val_j: jnp.ndarray     # [nG1 + 1] u boundaries


def partition_1axis(n: int, gs: int, ov: int):
    """Static per-axis partition (ObsGP.cpp:204-265). Returns
    (n_groups, i0 [nG], i1 [nG] inclusive, boundary_index [nG])."""
    n_groups = (n - ov) // gs + 1
    i0 = [g * gs for g in range(n_groups)]
    i1 = [g * gs + gs + ov - 1 if g < n_groups - 1 else n - 1
          for g in range(n_groups)]
    # boundary sample: i1 - ov//2 for interior, n-1 for the last
    bnd = [i1[g] - ov // 2 if g < n_groups - 1 else n - 1
           for g in range(n_groups)]
    return n_groups, i0, i1, bnd


def fit_obsgp2d(v_coords: jnp.ndarray, u_coords: jnp.ndarray,
                f: jnp.ndarray, param: ObsGPParam,
                c_cap: int = None) -> ObsGP2DState:
    """Train the partitioned 2D observation GP (ObsGP.cpp:280-342).

    v_coords: [NI] row ray coordinates (v = (row - cy)/fy, ascending)
    u_coords: [NJ] column ray coordinates (u = (col - cx)/fx, ascending)
    f: [NI, NJ] regression target (inverse depth 1/z; <= 0 marks invalid
       pixels, ObsGP.cpp:304)

    The partition is static (camera geometry); pixel validity is data.

    c_cap (static): compact the NON-EMPTY cells before the batched
    Cholesky pipeline and scatter alpha/L^-1 back into the full cell
    layout. A depth frame trains a small fraction of the 3072 cells, and
    the fit scales with batch, so fitting empty masked-identity systems
    is wasted work. Exact per trained cell (each cell's system is independent);
    callers pass the host-known nonempty-cell count's pow2 bucket
    (api3d._obs_cell_cap). None = fit every cell.
    """
    ni, nj = int(v_coords.shape[0]), int(u_coords.shape[0])
    gs, ov = param.group_size, param.overlap
    ng0, i0s, i1s, bnd_i = partition_1axis(ni, gs, ov)
    ng1, j0s, j1s, bnd_j = partition_1axis(nj, gs, ov)
    win = gs + ov  # max window extent per axis (i1 - i0 + 1 <= gs + ov)

    i0 = jnp.asarray(i0s)[:, None] + jnp.arange(win)[None, :]   # [nG0, W]
    irange = i0 <= jnp.asarray(i1s)[:, None]
    j0 = jnp.asarray(j0s)[:, None] + jnp.arange(win)[None, :]
    jrange = j0 <= jnp.asarray(j1s)[:, None]
    i0c = jnp.clip(i0, 0, ni - 1)
    j0c = jnp.clip(j0, 0, nj - 1)

    # cell (a, b) window pixels ordered column-outer/row-inner to match the
    # reference's gather order (ObsGP.cpp:301-309) — identical float
    # accumulation order in the per-cell Cholesky keeps f32 rounding
    # aligned with the reference (identity-masked rows contribute exact
    # zeros, so only the relative order of real pixels matters)
    rows = i0c[:, None, None, :]            # [nG0, 1, 1, W] (inner)
    cols = j0c[None, :, :, None]            # [1, nG1, W, 1] (outer)
    fv = f[rows, cols]                      # [nG0, nG1, Wj, Wi]
    inwin = irange[:, None, None, :] & jrange[None, :, :, None]
    pix_ok = inwin & (fv > 0)

    vs = v_coords[rows] + jnp.zeros_like(fv)
    us = u_coords[cols] + jnp.zeros_like(fv)
    m = win * win
    c = ng0 * ng1
    # cell-major flatten: cell index (a, b) -> a * nG1 + b
    x = jnp.stack([vs, us], axis=-1).reshape(c, m, 2)
    fcell = fv.reshape(c, m)
    vmask = pix_ok.reshape(c, m)

    trained = jnp.any(vmask, axis=-1)
    if c_cap is not None and c_cap < c:
        order = jnp.argsort(~trained, stable=True)       # nonempty first
        sel = order[:c_cap]
        selok = trained[sel]
        st_c = gp.fit_gpou(x[sel], fcell[sel], vmask[sel], param.scale,
                           param.noise)
        linv_c = gp.linv_from_chol(st_c.l)
        tgt = jnp.where(selok, sel, c)
        alpha = jnp.zeros((c + 1, m), x.dtype).at[tgt].set(
            st_c.alpha, mode='drop')[:-1]
        linv = jnp.zeros((c + 1, m, m), x.dtype).at[tgt].set(
            linv_c, mode='drop')[:-1]
    else:
        st = gp.fit_gpou(x, fcell, vmask, param.scale, param.noise)
        alpha = st.alpha
        linv = gp.linv_from_chol(st.l)

    val_i = jnp.concatenate([v_coords[:1], v_coords[jnp.asarray(bnd_i)]])
    val_j = jnp.concatenate([u_coords[:1], u_coords[jnp.asarray(bnd_j)]])
    return ObsGP2DState(x=x, valid=vmask, alpha=alpha, linv=linv,
                        trained=trained,
                        val_i=val_i, val_j=val_j)


def ownership_1axis(coords_np, bnd_np):
    """Static per-cell ownership ranges for one partition axis.

    Replicates the obsgp2d_test cell lookup (count of interior boundaries
    <= x, ObsGP.cpp:381-391) on the STATIC coordinate grid: returns
    idx [nG, W] coordinate indices owned by each cell (-1 padded).
    Ownership regions are contiguous; W = max count.
    """
    import numpy as np

    a_of = (bnd_np[None, :] <= coords_np[:, None]).sum(-1)
    a_of = np.clip(a_of, 0, len(bnd_np) - 1)
    ng = len(bnd_np)
    w = int(np.bincount(a_of, minlength=ng).max())
    idx = np.full((ng, w), -1, np.int32)
    for a in range(ng):
        rows = np.nonzero(a_of == a)[0]
        idx[a, :len(rows)] = rows
    return idx


def obsgp2d_test_blocked(state: ObsGP2DState, q: jnp.ndarray,
                         param: ObsGPParam, roff: int = 1):
    """obsgp2d_test for queries PRE-GROUPED by a static base cell.

    q: [nG0, nG1, T, 2] — block (i, j) holds queries whose true owning
    cell is within `roff` cells of (i, j) (callers guarantee this from
    static geometry: a probe displaces vu by <= delx/min_range, well
    under one cell span). Instead of gathering each query's [M, M]
    factor (16 KB/query of device-memory traffic in
    gpou_posterior_gather), every offset in the (2*roff+1)^2 ring evaluates
    ALL blocks against the SHIFTED cell grid — dense batched matmuls
    over contiguous state reads — and the true-cell match selects the
    result. Semantics identical to obsgp2d_test (same cell lookup,
    margins, sentinels).

    Returns (mean, var) [nG0, nG1, T].
    """
    ng0 = state.val_i.shape[0] - 1
    ng1 = state.val_j.shape[0] - 1
    mres = state.x.shape[1]
    v, u = q[..., 0], q[..., 1]
    m_ok = ((v >= state.val_i[0] + param.margin)
            & (v <= state.val_i[-1] - param.margin)
            & (u >= state.val_j[0] + param.margin)
            & (u <= state.val_j[-1] - param.margin))
    # true owning cell (identical comparisons to obsgp2d_test)
    a = jnp.searchsorted(state.val_i[1:], v.reshape(-1),
                         side='right').reshape(v.shape)
    b = jnp.searchsorted(state.val_j[1:], u.reshape(-1),
                         side='right').reshape(u.shape)
    a = jnp.clip(a, 0, ng0 - 1).astype(jnp.int32)
    b = jnp.clip(b, 0, ng1 - 1).astype(jnp.int32)

    x4 = state.x.reshape(ng0, ng1, mres, 2)
    al4 = state.alpha.reshape(ng0, ng1, mres)
    li4 = state.linv.reshape(ng0, ng1, mres, mres)
    vl4 = state.valid.reshape(ng0, ng1, mres)
    tr4 = state.trained.reshape(ng0, ng1)

    def shift(arr, da, db):
        """entry (i, j) -> arr[i + da, j + db], zero-filled outside."""
        pad = [(max(-da, 0), max(da, 0)), (max(-db, 0), max(db, 0))] \
            + [(0, 0)] * (arr.ndim - 2)
        ap = jnp.pad(arr, pad)
        sl = (slice(max(da, 0), max(da, 0) + ng0),
              slice(max(db, 0), max(db, 0) + ng1))
        return ap[sl]

    ii = jnp.arange(ng0, dtype=jnp.int32)[:, None, None]
    jj = jnp.arange(ng1, dtype=jnp.int32)[None, :, None]
    mean = jnp.zeros(v.shape, q.dtype)
    var = jnp.full(v.shape, _PAD_INVALID, q.dtype)
    for da in range(-roff, roff + 1):
        for db in range(-roff, roff + 1):
            sel = (a == ii + da) & (b == jj + db)
            xs = shift(x4, da, db)
            vl = shift(vl4, da, db)
            tr = shift(tr4, da, db)
            diff = xs[:, :, None, :, :] - q[:, :, :, None, :]
            r = jnp.sqrt(jnp.sum(diff * diff, -1))       # [g0,g1,T,M]
            ks = jnp.where(vl[:, :, None, :], jnp.exp(-r / param.scale),
                           0.0)
            mn = precision.einsum('ghtm,ghm->ght', ks,
                                  shift(al4, da, db))
            vv = precision.einsum('ghmn,ghtn->ghtm', shift(li4, da, db),
                                  ks)
            vr = 1.0 + param.noise - jnp.sum(vv * vv, -1)
            ok = sel & tr[:, :, None]
            mean = jnp.where(ok, mn, mean)
            var = jnp.where(ok, vr, var)
            # sel & ~trained: sentinel, already the init value
    mean = jnp.where(m_ok, mean, 0.0)
    var = jnp.where(m_ok, var, _PAD_INVALID)
    return mean, var


def obsgp2d_test(state: ObsGP2DState, vu: jnp.ndarray, param: ObsGPParam,
                 chunk: int = 4096):
    """Posterior at vu [Q, 2] = (v, u) pairs (ObsGP.cpp:352-408).

    Returns (mean [Q], var [Q]) with 1e6 sentinel outside the margins.
    """
    ng1 = state.val_j.shape[0] - 1
    v, u = vu[:, 0], vu[:, 1]
    m_ok = ((v >= state.val_i[0] + param.margin)
            & (v <= state.val_i[-1] - param.margin)
            & (u >= state.val_j[0] + param.margin)
            & (u <= state.val_j[-1] - param.margin))
    # first boundary strictly greater (reference `if (x < *it) break`,
    # ObsGP.cpp:381-391): count of interior boundaries <= x
    a = jnp.sum(state.val_i[None, 1:] <= v[:, None], axis=-1)
    b = jnp.sum(state.val_j[None, 1:] <= u[:, None], axis=-1)
    a = jnp.clip(a, 0, state.val_i.shape[0] - 2).astype(jnp.int32)
    b = jnp.clip(b, 0, ng1 - 1).astype(jnp.int32)
    cell = a * ng1 + b

    mean, var = gp.gpou_posterior_gather(
        state.x, state.alpha, state.linv, state.valid, state.trained,
        cell, vu, param.scale, param.noise, chunk)
    mean = jnp.where(m_ok, mean, 0.0)
    var = jnp.where(m_ok, var, _PAD_INVALID)
    return mean, var
