"""3D online mapper — device-side computations.

Batched re-expression of the reference GPisMap3 pipeline
(reference: cpp/src/GPisMap3.cpp:125-716): depth-image preprocessing with
camera intrinsics, re-evaluation of existing nodes against the ObsGP2D
inverse-depth regression, 6-probe normals, quaternion normal fusion, and
per-pixel new-measurement evaluation.

Reference quirks handled explicitly:
  * compat re-localization: the reference recomputes vu from UNCHANGED
    y_loc/z_loc inside the refinement loop (GPisMap3.cpp:390-392), so the
    occupancy never updates and the loop degenerates to 10 fixed-sign
    steps of geometrically growing size. `compat=True` (default)
    reproduces this closed form for golden parity; `compat=False` runs the
    corrected loop that re-projects x_new each step.
  * the normal-fusion quaternion is built from an UN-normalized axis
    (GPisMap3.cpp:509-529) and the `ang > 1-6` guard is always true;
    replicated as written (with an acos clamp to avoid NaN).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CameraParam, MapperParam, ObsGPParam
from ..ops.precision import matmul
from . import obsgp
from .mapper2d import occ_test

_RELOC_ITERS = 10
_OCC_STOP = 0.02
# sum of 10 steps with dx *= 1.1 growth (GPisMap3.cpp:374-410 compat path)
_COMPAT_STEP_SUM = sum(1.1 ** i for i in range(_RELOC_ITERS))


class Preproc3D(NamedTuple):
    valid: jnp.ndarray        # [M, N] range-gated pixels (row-major m x n)
    zinv: jnp.ndarray         # [M, N] inverse depth (-1 invalid)
    v: jnp.ndarray            # [M] row ray coords (row - cy)/fy
    u: jnp.ndarray            # [N] col ray coords (col - cx)/fx
    xyz_local: jnp.ndarray    # [M, N, 3]
    xyz_global: jnp.ndarray   # [M, N, 3]
    z: jnp.ndarray            # [M, N] depth
    range_obs_max: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cam", "mp"))
def preprocess_3d(depth: jnp.ndarray, tr: jnp.ndarray, rot: jnp.ndarray,
                  cam: CameraParam, mp: MapperParam) -> Preproc3D:
    """Depth subsample + back-projection (GPisMap3.cpp:125-216).

    depth: [H, W] meters; rot: [3, 3] world-from-camera; tr: [3].
    """
    skip = mp.obs_skip
    m = cam.height // skip
    n = cam.width // skip
    rows = jnp.arange(m) * skip
    cols = jnp.arange(n) * skip
    z = depth[rows][:, cols]                           # [M, N]
    valid = (z > mp.min_range) & (z < mp.max_range)
    zinv = jnp.where(valid, 1.0 / jnp.maximum(z, 1e-12), -1.0)
    v = (rows.astype(depth.dtype) - cam.cy) / cam.fy
    u = (cols.astype(depth.dtype) - cam.cx) / cam.fx
    x_l = u[None, :] * z
    y_l = v[:, None] * z
    loc = jnp.stack([x_l, y_l, z], -1)
    glob = matmul(loc, rot.T) + tr
    rmax = jnp.max(jnp.where(valid, z, 0.0))
    return Preproc3D(valid=valid, zinv=zinv, v=v, u=u, xyz_local=loc,
                     xyz_global=glob, z=z, range_obs_max=rmax)


class Reeval3D(NamedTuple):
    action: jnp.ndarray
    pos: jnp.ndarray
    grad: jnp.ndarray
    noise: jnp.ndarray
    grad_noise: jnp.ndarray
    dbl_pos_sig: jnp.ndarray
    dbl_grad_sig: jnp.ndarray


def _quat_blend(grad_old, grad_new, frac):
    """Reference normal fusion (GPisMap3.cpp:508-529): rotate the OLD
    normal by frac*angle(new, old) about the un-normalized axis
    new x old, through the aerospace DCM applied transposed."""
    axis = jnp.cross(grad_new, grad_old)
    dot = jnp.clip(jnp.sum(grad_new * grad_old, -1), -1.0, 1.0)
    ang = jnp.arccos(dot) * frac
    q0 = jnp.cos(ang / 2.0)
    s = jnp.sin(ang / 2.0)
    q1, q2, q3 = axis[..., 0] * s, axis[..., 1] * s, axis[..., 2] * s
    # dcm column-major of R (quat2dcm, GPisMap3.cpp:48-63); applied as
    # grad = R^T @ grad_old (GPisMap3.cpp:527-529)
    r00 = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3
    r10 = 2.0 * (q1 * q2 + q0 * q3)
    r20 = 2.0 * (q1 * q3 - q0 * q2)
    r01 = 2.0 * (q1 * q2 - q0 * q3)
    r11 = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3
    r21 = 2.0 * (q0 * q1 + q2 * q3)
    r02 = 2.0 * (q1 * q3 + q0 * q2)
    r12 = 2.0 * (q2 * q3 - q0 * q1)
    r22 = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3
    gx, gy, gz = grad_old[..., 0], grad_old[..., 1], grad_old[..., 2]
    return jnp.stack([r00 * gx + r10 * gy + r20 * gz,
                      r01 * gx + r11 * gy + r21 * gz,
                      r02 * gx + r12 * gy + r22 * gz], -1)


@functools.partial(jax.jit,
                   static_argnames=("mp", "op", "chunk", "compat"))
def reeval_3d(obs: obsgp.ObsGP2DState, pos: jnp.ndarray, grad: jnp.ndarray,
              pos_sig: jnp.ndarray, grad_sig: jnp.ndarray,
              valid: jnp.ndarray, tr: jnp.ndarray, rot: jnp.ndarray,
              mp: MapperParam, op: ObsGPParam, chunk: int = 1024,
              compat: bool = True) -> Reeval3D:
    """Batched reEvalPoints (GPisMap3.cpp:321-569)."""
    return _reeval_core(obs, pos, grad, pos_sig, grad_sig, valid, tr, rot,
                        mp, op, chunk, compat)


def _reeval_core(obs: obsgp.ObsGP2DState, pos: jnp.ndarray,
                 grad: jnp.ndarray, pos_sig: jnp.ndarray,
                 grad_sig: jnp.ndarray, valid: jnp.ndarray, tr: jnp.ndarray,
                 rot: jnp.ndarray, mp: MapperParam, op: ObsGPParam,
                 chunk: int, compat: bool) -> Reeval3D:
    """reEvalPoints math for one node batch (trace-level; see reeval_3d)."""
    k = pos.shape[0]

    def obs_at_vu(vu_flat):
        mmean, vvar = obsgp.obsgp2d_test(obs, vu_flat, op, chunk)
        return mmean, vvar

    loc = matmul(pos - tr, rot)                           # R^T (p - t)
    x_l, y_l, z_l = loc[..., 0], loc[..., 1], loc[..., 2]
    front = z_l > 0.0                                  # GPisMap3.cpp:342
    zs = jnp.where(jnp.abs(z_l) > 1e-12, z_l, 1e-12)
    vu = jnp.stack([y_l / zs, x_l / zs], -1)
    rinv0, var = obs_at_vu(vu)
    gate = valid & front & (var <= mp.obs_var_thre)
    oc0 = occ_test(1.0 / zs, rinv0, z_l * 30.0)
    active = gate & (oc0 >= -0.02)                     # GPisMap3.cpp:355-359
    grad_loc = matmul(grad, rot)

    if compat:
        # closed form of the degenerate loop (see module docstring)
        move = jnp.abs(oc0) > _OCC_STOP
        sgn = jnp.where(oc0 < 0, 1.0, -1.0)
        disp = sgn * mp.delx * _COMPAT_STEP_SUM
        x_new = loc + jnp.where(move[:, None], grad_loc * disp[:, None],
                                0.0)
        abs_oc = jnp.abs(oc0)
        r_new = z_l
    else:
        def body(i, st):
            x_new, dx, oc, abs_oc, r_new, cont = st
            step = jnp.where(oc[:, None] < 0, 1.0, -1.0) * grad_loc \
                * dx[:, None]
            x_new = jnp.where(cont[:, None], x_new + step, x_new)
            zc = jnp.where(jnp.abs(x_new[:, 2]) > 1e-12, x_new[:, 2], 1e-12)
            vu_i = jnp.stack([x_new[:, 1] / zc, x_new[:, 0] / zc], -1)
            rinv0_n, var_n = obs_at_vu(vu_i)
            r_t = x_new[:, 2]
            r_new = jnp.where(cont, r_t, r_new)
            brk_var = var_n > mp.obs_var_thre
            oc_n = occ_test(1.0 / jnp.maximum(r_t, 1e-12), rinv0_n,
                            r_t * 30.0)
            brk_oc = (jnp.abs(oc_n) < _OCC_STOP) | (oc < -0.02)
            upd = cont & ~brk_var & ~brk_oc
            flip = oc * oc_n < 0.0
            dx = jnp.where(upd, jnp.where(flip, 0.5 * dx, 1.1 * dx), dx)
            oc = jnp.where(upd, oc_n, oc)
            abs_oc = jnp.where(upd, jnp.abs(oc_n), abs_oc)
            cont = upd & (jnp.abs(oc_n) > _OCC_STOP)
            return x_new, dx, oc, abs_oc, r_new, cont

        abs0 = jnp.abs(oc0)
        st0 = (loc, jnp.full((k,), mp.delx, pos.dtype), oc0, abs0, z_l,
               active & (abs0 > _OCC_STOP))
        x_new, _, _, abs_oc, r_new, _ = jax.lax.fori_loop(
            0, _RELOC_ITERS, body, st0)

    # --- 6-probe normal + noise (GPisMap3.cpp:413-480) ---
    w = 1.0 / 6.0
    pert = jnp.asarray([[1., 0., 0.], [-1., 0., 0.], [0., 1., 0.],
                        [0., -1., 0.], [0., 0., 1.], [0., 0., -1.]],
                       pos.dtype) * mp.delx
    ppos = x_new[:, None, :] + pert[None]              # [K, 6, 3]
    pz = jnp.where(jnp.abs(ppos[..., 2]) > 1e-12, ppos[..., 2], 1e-12)
    pvu = jnp.stack([ppos[..., 1] / pz, ppos[..., 0] / pz], -1)
    prinv0, pvar = obs_at_vu(pvu.reshape(-1, 2))
    prinv0 = prinv0.reshape(k, 6)
    pvar = pvar.reshape(k, 6)
    probe_ok = jnp.all(pvar <= mp.obs_var_thre, -1)
    pocc = occ_test(1.0 / pz, prinv0, ppos[..., 2] * 30.0)
    occ_mean = w * jnp.sum(pocc, -1)
    r0 = 1.0 / jnp.where(jnp.abs(prinv0) > 1e-12, prinv0, 1e-12)
    r0_sqr_sum = jnp.sum(r0 * r0, -1)
    r0_mean = w * jnp.sum(r0, -1)

    act2 = active & probe_ok
    gnl = jnp.stack([pocc[:, 0] - pocc[:, 1], pocc[:, 2] - pocc[:, 3],
                     pocc[:, 4] - pocc[:, 5]], -1) / mp.delx
    norm_g = jnp.sqrt(jnp.sum(gnl * gnl, -1))
    dbl = act2 & (norm_g < 1e-3)
    act3 = act2 & (norm_g >= 1e-3)

    r_var = (r0_sqr_sum / 5.0 - r0_mean * r0_mean * 6.0 / 5.0) / mp.delx
    gnl_n = gnl / jnp.maximum(norm_g, 1e-12)[:, None]
    # reference quirk: the probe loop overwrites r_new with each probe's z
    # (GPisMap3.cpp:429), so the noise model sees the LAST probe's depth
    # x_new_z - delx, not the relocated depth
    r_probe = x_new[:, 2] - mp.delx
    noise = mp.min_position_noise * jnp.clip(r_probe * r_probe, 1.0, 100.0)
    grad_noise = jnp.clip(jnp.abs(occ_mean) + r_var, mp.min_grad_noise, 1.0)
    dist = jnp.sqrt(jnp.sum(x_new * x_new, -1))
    view_ang = jnp.maximum(
        -jnp.sum(x_new * gnl_n, -1) / jnp.maximum(dist, 1e-12), 0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise = noise + view_noise + abs_oc
    grad_noise = grad_noise + 0.1 * view_noise

    pos_new = matmul(x_new, rot.T) + tr
    grad_new = matmul(gnl_n, rot.T)

    # --- fusion (GPisMap3.cpp:497-534) ---
    fuse = grad_sig <= 0.5
    psum = pos_sig + noise
    pos_f = (noise[:, None] * pos + pos_sig[:, None] * pos_new) / psum[:, None]
    dist_f = 0.5 * jnp.sqrt(jnp.sum((pos - pos_f) ** 2, -1))
    grad_f = _quat_blend(grad, grad_new, noise / psum)
    gsum = grad_sig + grad_noise
    gnoise_f = jnp.minimum(
        1.0, jnp.maximum(grad_noise * grad_sig / gsum + dist_f,
                         mp.map_noise_param))
    noise_f = jnp.maximum(noise * pos_sig / psum + dist_f,
                          mp.map_noise_param)

    pos_out = jnp.where(fuse[:, None], pos_f, pos_new)
    grad_out = jnp.where(fuse[:, None], grad_f, grad_new)
    noise_out = jnp.where(fuse, noise_f, noise)
    gnoise_out = jnp.where(fuse, gnoise_f, grad_noise)

    discard = (noise_out > 1.0) & (gnoise_out > 0.61)
    action = jnp.where(
        dbl, 1, jnp.where(act3 & discard, 2,
                          jnp.where(act3, 3, 0))).astype(jnp.int32)
    return Reeval3D(action=action, pos=pos_out, grad=grad_out,
                    noise=noise_out, grad_noise=gnoise_out,
                    dbl_pos_sig=2.0 * pos_sig, dbl_grad_sig=2.0 * grad_sig)


@functools.partial(jax.jit, static_argnames=("mp", "op", "chunk", "compat",
                                             "kc"))
def reeval_scan_3d(obs: obsgp.ObsGP2DState, pos: jnp.ndarray,
                   grad: jnp.ndarray, pos_sig: jnp.ndarray,
                   grad_sig: jnp.ndarray, valid: jnp.ndarray,
                   cell_coords: jnp.ndarray, cell_ok: jnp.ndarray,
                   tr: jnp.ndarray, rot: jnp.ndarray, cell_size,
                   mp: MapperParam, op: ObsGPParam, chunk: int = 4096,
                   compat: bool = True, kc: int = 512):
    """Fused strict re-evaluation: ONE device program scanning the kept
    cluster cells in reference order (the outer per-cell loop of
    reEvalPoints, GPisMap3.cpp:321-569, which the host replay pays ~26
    blocking dispatches per frame for).

    Strict semantics hold on device: each cell's member set is recomputed
    from the CURRENT node positions (floor(pos/cell_size) == cell integer
    coords — the alignment invariant cluster cells already satisfy, see
    api3d._rebuild_grid), so a node relocated by an earlier cell into a
    later kept cell is re-evaluated there, exactly like the reference's
    gather-at-processing-time loop. The one divergence from the per-cell
    host replay: in-frame insertion dedup (quadtree.cpp:325-348) is only
    resolved by the host apply at frame end, so a mid-frame relocation
    collision survives until then.

    pos/grad [K, 3], pos_sig/grad_sig/valid [K]; cell_coords [C, 3] int32
    in processing order with cell_ok [C] marking real cells. Each step
    compacts members to a static bound kc (next-pow2 of the largest start
    cell plus headroom; overflow counted, not silently lost).

    Returns (Reeval3D with FINAL per-node composite actions/values,
    n_dropped). Composite action: removed anywhere -> 2; relocated (and
    possibly later doubled) -> 3 with the final table values; noise
    doubled only -> 1; untouched -> 0. The host applies each node once
    (runtime/index.apply_reeval), reproducing the sequential tree state.
    """
    k = pos.shape[0]

    def step(carry, cell):
        coords, ok = cell
        p, g, ps, gs, alv, moved, dbl, drop = carry
        kcell = jnp.floor(p / cell_size).astype(jnp.int32)
        member = alv & ok & jnp.all(kcell == coords[None, :], axis=-1)
        drop = drop + jnp.maximum(jnp.sum(member) - kc, 0).astype(jnp.int32)
        idx = jnp.nonzero(member, size=kc, fill_value=k)[0]
        got = idx < k
        ic = jnp.clip(idx, 0, k - 1)
        rv = _reeval_core(obs, p[ic], g[ic], ps[ic], gs[ic], got, tr, rot,
                          mp, op, chunk, compat)
        a = jnp.where(got, rv.action, 0)
        new_p = jnp.where((a == 3)[:, None], rv.pos, p[ic])
        new_g = jnp.where((a == 3)[:, None], rv.grad, g[ic])
        new_ps = jnp.where(a == 1, rv.dbl_pos_sig,
                           jnp.where(a == 3, rv.noise, ps[ic]))
        new_gs = jnp.where(a == 1, rv.dbl_grad_sig,
                           jnp.where(a == 3, rv.grad_noise, gs[ic]))

        def scat(old, new):
            ext = jnp.concatenate(
                [old, jnp.zeros((1,) + old.shape[1:], old.dtype)])
            return ext.at[idx].set(new, mode='drop')[:-1]

        carry = (scat(p, new_p), scat(g, new_g), scat(ps, new_ps),
                 scat(gs, new_gs), scat(alv, a != 2),
                 scat(moved, moved[ic] | (a == 3)),
                 scat(dbl, dbl[ic] | (a == 1)), drop)
        return carry, None

    init = (pos, grad, pos_sig, grad_sig, valid,
            jnp.zeros((k,), bool), jnp.zeros((k,), bool),
            jnp.zeros((), jnp.int32))
    (p, g, ps, gs, alv, moved, dbl, drop), _ = jax.lax.scan(
        step, init, (cell_coords, cell_ok))
    removed = valid & ~alv
    action = jnp.where(removed, 2,
                       jnp.where(moved, 3,
                                 jnp.where(dbl, 1, 0))).astype(jnp.int32)
    return Reeval3D(action=action, pos=p, grad=g, noise=ps, grad_noise=gs,
                    dbl_pos_sig=ps, dbl_grad_sig=gs), drop


@functools.partial(jax.jit, static_argnames=("mp", "op", "chunk", "compat",
                                             "max_movers", "rounds"))
def reeval_hybrid_3d(obs: obsgp.ObsGP2DState, pos: jnp.ndarray,
                     grad: jnp.ndarray, pos_sig: jnp.ndarray,
                     grad_sig: jnp.ndarray, valid: jnp.ndarray,
                     cell_coords: jnp.ndarray, cell_ok: jnp.ndarray,
                     tr: jnp.ndarray, rot: jnp.ndarray, cell_size,
                     mp: MapperParam, op: ObsGPParam, chunk: int = 4096,
                     compat: bool = True, max_movers: int = 128,
                     rounds: int = 4):
    """Strict per-cell re-evaluation, restructured as ONE vectorized pass
    + a tiny mover fix-up — observably equivalent to reeval_scan_3d
    (the per-cell sequential order of reEvalPoints, GPisMap3.cpp:321-569)
    at a fraction of its sequential depth.

    Key fact: in the sequential order, every node's FIRST processing
    reads frame-start state, because a node lives in exactly one cell
    and earlier cells cannot have touched it. So pass 1 re-evaluates ALL
    kept-cell nodes in one batch. The only second processings the strict
    order performs are for nodes RELOCATED across a cell boundary into a
    LATER kept cell (they re-enter a pending cell's member set,
    GPisMap3.cpp:321-341); those (typically 0-20/frame) re-process from
    their updated state in fix-up rounds until the chain drains
    (`rounds` bounds the chain depth; leftovers + mover overflow are
    counted in n_dropped, never silent).

    Same signature/returns as reeval_scan_3d.
    """
    k = pos.shape[0]
    c = cell_coords.shape[0]

    def cell_ord(p, alv):
        """Processing-order index of each node's current cell (c = not a
        kept cell). Kept cells arrive in reference traversal order."""
        kcell = jnp.floor(p / cell_size).astype(jnp.int32)
        eq = jnp.all(kcell[:, None, :] == cell_coords[None], -1) \
            & cell_ok[None]
        has = jnp.any(eq, -1)
        o = jnp.argmax(eq, -1).astype(jnp.int32)
        return jnp.where(alv & has, o, c)

    ord0 = cell_ord(pos, valid)
    member0 = ord0 < c

    # ---- pass 1: every node's first processing, one batch ----
    rv = _reeval_core(obs, pos, grad, pos_sig, grad_sig, member0, tr, rot,
                      mp, op, chunk, compat)
    a = jnp.where(member0, rv.action, 0)
    p = jnp.where((a == 3)[:, None], rv.pos, pos)
    g = jnp.where((a == 3)[:, None], rv.grad, grad)
    ps = jnp.where(a == 1, rv.dbl_pos_sig,
                   jnp.where(a == 3, rv.noise, pos_sig))
    gs = jnp.where(a == 1, rv.dbl_grad_sig,
                   jnp.where(a == 3, rv.grad_noise, grad_sig))
    alv = valid & (a != 2)
    moved = a == 3
    dbl = a == 1
    ord1 = cell_ord(p, alv)
    pending = moved & alv & (ord1 < c) & (ord1 > ord0)
    drop0 = jnp.zeros((), jnp.int32)

    # ---- fix-up rounds: re-process forward-movers from updated state ----
    mchunk = max(256, min(chunk, _next_pow2_static(max_movers * 7)))

    def cond(st):
        r = st[-1]
        return jnp.any(st[7]) & (r < rounds)

    def body(st):
        p, g, ps, gs, alv, moved, dbl, pending, drop, r = st
        npend = jnp.sum(pending)
        drop = drop + jnp.maximum(npend - max_movers, 0).astype(jnp.int32)
        idx = jnp.nonzero(pending, size=max_movers, fill_value=k)[0]
        got = idx < k
        ic = jnp.clip(idx, 0, k - 1)
        my_ord = cell_ord(p, alv)[ic]        # cell being processed now
        rv = _reeval_core(obs, p[ic], g[ic], ps[ic], gs[ic], got, tr, rot,
                          mp, op, mchunk, compat)
        a = jnp.where(got, rv.action, 0)
        new_p = jnp.where((a == 3)[:, None], rv.pos, p[ic])
        new_g = jnp.where((a == 3)[:, None], rv.grad, g[ic])
        new_ps = jnp.where(a == 1, rv.dbl_pos_sig,
                           jnp.where(a == 3, rv.noise, ps[ic]))
        new_gs = jnp.where(a == 1, rv.dbl_grad_sig,
                           jnp.where(a == 3, rv.grad_noise, gs[ic]))
        new_alv = alv[ic] & (a != 2)
        # moved again across a boundary into a cell later than the one
        # just processed -> pending again (chain)
        kc_old = jnp.floor(p[ic] / cell_size).astype(jnp.int32)
        kc_new = jnp.floor(new_p / cell_size).astype(jnp.int32)
        crossed = jnp.any(kc_old != kc_new, -1)
        repend = got & (a == 3) & new_alv & crossed

        def scat(old, new):
            ext = jnp.concatenate(
                [old, jnp.zeros((1,) + old.shape[1:], old.dtype)])
            return ext.at[idx].set(new, mode='drop')[:-1]

        p2 = scat(p, new_p)
        alv2 = scat(alv, new_alv)
        # clear the processed flags, then re-flag chained movers:
        # forwardness = target ord (of the node's NEW cell) > ord of the
        # cell it was just processed in
        pending2 = scat(pending, jnp.zeros_like(got))
        tgt_ord = cell_ord(p2, alv2)[ic]
        again = repend & (tgt_ord < c) & (tgt_ord > my_ord)
        pending2 = scat(pending2, again)
        return (p2, scat(g, new_g), scat(ps, new_ps), scat(gs, new_gs),
                alv2, scat(moved, moved[ic] | (a == 3)),
                scat(dbl, dbl[ic] | (a == 1)), pending2, drop, r + 1)

    st0 = (p, g, ps, gs, alv, moved, dbl, pending, drop0,
           jnp.zeros((), jnp.int32))
    p, g, ps, gs, alv, moved, dbl, pending, drop, _ = jax.lax.while_loop(
        cond, body, st0)
    drop = drop + jnp.sum(pending).astype(jnp.int32)  # undrained chain
    removed = valid & ~alv
    action = jnp.where(removed, 2,
                       jnp.where(moved, 3,
                                 jnp.where(dbl, 1, 0))).astype(jnp.int32)
    return Reeval3D(action=action, pos=p, grad=g, noise=ps, grad_noise=gs,
                    dbl_pos_sig=ps, dbl_grad_sig=gs), drop


def _next_pow2_static(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class NewMeas3D(NamedTuple):
    insert_ok: jnp.ndarray   # [P] flattened column-major over (n, m)
    pos: jnp.ndarray         # [P, 3]
    grad: jnp.ndarray        # [P, 3]
    noise: jnp.ndarray       # [P]
    grad_noise: jnp.ndarray  # [P]


def _obs_blocked_default() -> bool:
    """Cell-blocked ObsGP2D evaluation (obsgp2d_test_blocked) — the probe
    sweep as dense shifted matmuls instead of per-query factor gathers
    (16 KB of factor per query). The default was chosen on the H100
    (CHANGES.md); GPISMAP_OBS_BLOCKED=0/1 overrides."""
    import os
    return os.environ.get("GPISMAP_OBS_BLOCKED", "0") in ("1", "on")


def _grid_ownership(cam: CameraParam, mp: MapperParam, op: ObsGPParam):
    """Static pixel->cell ownership tables for the (v, u) ray grid.

    The obs partition boundaries are pure camera geometry
    (GPisMap3.cpp:144-173 + ObsGP.cpp:204-265), so each PIXEL's owning
    cell is known at trace time. Returns (row_idx [nG0, W0],
    col_idx [nG1, W1]) with -1 padding.
    """
    import numpy as np

    skip = mp.obs_skip
    m = cam.height // skip
    n = cam.width // skip
    v_np = ((np.arange(m) * skip).astype(np.float32)
            - np.float32(cam.cy)) / np.float32(cam.fy)
    u_np = ((np.arange(n) * skip).astype(np.float32)
            - np.float32(cam.cx)) / np.float32(cam.fx)
    _, _, _, bnd_i = obsgp.partition_1axis(m, op.group_size, op.overlap)
    _, _, _, bnd_j = obsgp.partition_1axis(n, op.group_size, op.overlap)
    row_idx = obsgp.ownership_1axis(v_np, v_np[np.asarray(bnd_i)])
    col_idx = obsgp.ownership_1axis(u_np, u_np[np.asarray(bnd_j)])
    return row_idx, col_idx


def _blocked_obs_sweep(obs, vu0, pvu, cam: CameraParam, mp: MapperParam,
                       op: ObsGPParam):
    """Gate + probe ObsGP posteriors via the cell-blocked evaluator.

    Groups the [M, N] pixel grid by static owning cell. Gate queries sit
    exactly in their cell (roff=0); probes displace vu by at most
    ~delx/min_range + |vu|*delx/min_range, well under one cell span for
    the production geometry, so roff=1 covers every valid pixel's probes.
    Returns (var0 [M, N], prinv0 [M, N, 6], pvar [M, N, 6]).
    """
    import numpy as np

    m, n = vu0.shape[:2]
    row_idx, col_idx = _grid_ownership(cam, mp, op)
    ng0, w0 = row_idx.shape
    ng1, w1 = col_idx.shape
    rc = jnp.asarray(np.clip(row_idx, 0, m - 1))
    cc = jnp.asarray(np.clip(col_idx, 0, n - 1))
    qmask = jnp.asarray((row_idx >= 0)[:, None, :, None]
                        & (col_idx >= 0)[None, :, None, :])  # [g0,g1,W0,W1]

    def group(arr):
        """[M, N, ...] -> [nG0, nG1, W0*W1, ...] by ownership."""
        g1 = arr[rc]                       # [g0, W0, N, ...]
        g2 = g1[:, :, cc]                  # [g0, W0, g1, W1, ...]
        g2 = jnp.moveaxis(g2, 2, 1)        # [g0, g1, W0, W1, ...]
        return g2.reshape((ng0, ng1, w0 * w1) + arr.shape[2:])

    # scatter-back pixel ids (static)
    pid_np = np.where(
        (row_idx >= 0)[:, None, :, None] & (col_idx >= 0)[None, :, None, :],
        np.clip(row_idx, 0, m - 1)[:, None, :, None] * n
        + np.clip(col_idx, 0, n - 1)[None, :, None, :], m * n)
    pid = jnp.asarray(pid_np.reshape(ng0, ng1, w0 * w1))

    def scatter(vals, init):
        """[g0, g1, T, ...] -> [M*N, ...] by pixel id (pad row dropped)."""
        ext = jnp.concatenate(
            [init, jnp.zeros((1,) + init.shape[1:], init.dtype)])
        flat = vals.reshape((-1,) + vals.shape[3:])
        return ext.at[pid.reshape(-1)].set(flat, mode='drop')[:-1]

    # ---- gate ----
    qg = group(vu0)                                    # [g0,g1,T,2]
    _, varg = obsgp.obsgp2d_test_blocked(obs, qg, op, roff=0)
    var0 = scatter(varg, jnp.full((m * n,), 1e6, vu0.dtype)).reshape(m, n)

    # ---- probes (6 per pixel) ----
    qp = group(pvu)                                    # [g0,g1,T,6,2]
    qp = qp.reshape(ng0, ng1, w0 * w1 * 6, 2)
    mnp, varp = obsgp.obsgp2d_test_blocked(obs, qp, op, roff=1)
    mnp = mnp.reshape(ng0, ng1, w0 * w1, 6)
    varp = varp.reshape(ng0, ng1, w0 * w1, 6)
    prinv0 = scatter(mnp, jnp.zeros((m * n, 6), vu0.dtype)).reshape(m, n, 6)
    pvar = scatter(varp, jnp.full((m * n, 6), 1e6,
                                  vu0.dtype)).reshape(m, n, 6)
    return var0, prinv0, pvar


@functools.partial(jax.jit, static_argnames=("cam", "mp", "op", "chunk",
                                             "blocked", "nv_cap"))
def newmeas_3d(obs: obsgp.ObsGP2DState, prep: Preproc3D, rot: jnp.ndarray,
               mp: MapperParam, op: ObsGPParam,
               chunk: int = 4096, cam: CameraParam = None,
               blocked: bool = False, nv_cap: int = None) -> NewMeas3D:
    """Batched evalPoints (GPisMap3.cpp:580-696).

    Outputs are flattened in the reference's pixel iteration order
    (column-major: outer col, inner row; GPisMap3.cpp:586-589) so the host
    insertion replay preserves dedup order.

    blocked=True (requires cam) routes the ~537k ObsGP posteriors through
    the cell-blocked evaluator (see _blocked_obs_sweep) — same math, the
    per-query factor gather replaced by dense batched matmuls.

    nv_cap (static; wins over blocked): compact the range-gated pixels
    first and run the PLAIN gather evaluator on their 7*nv_cap queries
    only. A depth frame gates out most pixels, so both dense sweeps
    burn many times the needed posterior evaluations; callers know nv on the
    host before dispatch (api3d._host_gate) and pass its pow2 bucket.
    Evaluated pixels take the identical gather path the goldens use;
    gated-out pixels get the 1e6 sentinel, which downstream gates
    already imply (insert_ok &= prep.valid). Equivalence vs the dense
    paths is suite-gated on real frames (tests/test_obsgp.py).
    """
    m, n = prep.valid.shape
    w = 1.0 / 6.0

    vu0 = jnp.stack([jnp.broadcast_to(prep.v[:, None], (m, n)),
                     jnp.broadcast_to(prep.u[None, :], (m, n))], -1)
    pert = jnp.asarray([[1., 0., 0.], [-1., 0., 0.], [0., 1., 0.],
                        [0., -1., 0.], [0., 0., 1.], [0., 0., -1.]],
                       prep.z.dtype) * mp.delx
    ppos = prep.xyz_local[:, :, None, :] + pert[None, None]   # [M,N,6,3]
    pz = jnp.where(jnp.abs(ppos[..., 2]) > 1e-12, ppos[..., 2], 1e-12)
    pvu = jnp.stack([ppos[..., 1] / pz, ppos[..., 0] / pz], -1)

    if nv_cap is not None:
        mn_ = m * n
        nv_cap = min(nv_cap, mn_)          # a small image: every pixel
        vflat = prep.valid.reshape(-1)
        order = jnp.argsort(~vflat, stable=True)      # valid-first
        sel = order[:nv_cap]                          # [NV]
        selok = vflat[sel]
        q = jnp.concatenate(
            [vu0.reshape(-1, 2)[sel][:, None, :],
             pvu.reshape(mn_, 6, 2)[sel]], axis=1)    # [NV, 7, 2]
        mean_c, var_c = obsgp.obsgp2d_test(obs, q.reshape(-1, 2), op,
                                           chunk)
        mean_c = mean_c.reshape(nv_cap, 7)
        var_c = var_c.reshape(nv_cap, 7)
        tgt = jnp.where(selok, sel, mn_)

        def scat(vals, fill):
            init = jnp.full((mn_ + 1,) + vals.shape[1:], fill, vals.dtype)
            return init.at[tgt].set(vals, mode='drop')[:-1]

        var0 = scat(var_c[:, 0], obsgp._PAD_INVALID).reshape(m, n)
        prinv0 = scat(mean_c[:, 1:7], 0.0).reshape(m, n, 6)
        pvar = scat(var_c[:, 1:7], obsgp._PAD_INVALID).reshape(m, n, 6)
    elif blocked:
        var0, prinv0, pvar = _blocked_obs_sweep(obs, vu0, pvu, cam, mp, op)
    else:
        _, var0 = obsgp.obsgp2d_test(obs, vu0.reshape(-1, 2), op, chunk)
        var0 = var0.reshape(m, n)
        prinv0, pvar = obsgp.obsgp2d_test(obs, pvu.reshape(-1, 2), op,
                                          chunk)
        prinv0 = prinv0.reshape(m, n, 6)
        pvar = pvar.reshape(m, n, 6)
    gate = prep.valid & (var0 <= mp.obs_var_thre)
    probe_ok = jnp.all(pvar <= mp.obs_var_thre, -1)
    pocc = occ_test(1.0 / pz, prinv0, ppos[..., 2] * 30.0)
    occ_mean = w * jnp.sum(pocc, -1)

    graw = jnp.stack([pocc[..., 0] - pocc[..., 1],
                      pocc[..., 2] - pocc[..., 3],
                      pocc[..., 4] - pocc[..., 5]], -1) / mp.delx
    norm2 = jnp.sum(graw * graw, -1)
    hasg = norm2 > 1e-6
    norm = jnp.sqrt(jnp.maximum(norm2, 1e-24))
    gl = graw / norm[..., None]
    gglob = matmul(gl, rot.T)

    dist = jnp.sqrt(jnp.sum(prep.xyz_local ** 2, -1))
    # 3D quirk: position noise saturates the LOCAL DISTANCE, not range^2
    # (GPisMap3.cpp:676)
    noise_g = mp.min_position_noise * jnp.clip(dist, 1.0, 100.0)
    gnoise_g = jnp.clip(jnp.abs(occ_mean), mp.min_grad_noise, 1.0)
    view_ang = jnp.maximum(
        -jnp.sum(prep.xyz_local * gl, -1) / jnp.maximum(dist, 1e-12), 0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise_g = noise_g + view_noise

    grad_out = jnp.where(hasg[..., None], gglob, graw)
    noise = jnp.where(hasg, noise_g, 100.0)
    gnoise = jnp.where(hasg, gnoise_g, 1.0)

    def colmajor(a):
        return jnp.swapaxes(a, 0, 1).reshape((m * n,) + a.shape[2:])

    return NewMeas3D(insert_ok=colmajor(gate & probe_ok),
                     pos=colmajor(prep.xyz_global),
                     grad=colmajor(grad_out), noise=colmajor(noise),
                     grad_noise=colmajor(gnoise))


@functools.partial(jax.jit, static_argnames=("cam", "mp", "op", "chunk",
                                             "blocked", "nv_cap",
                                             "obs_c_cap"))
def frame_compute_3d(depth: jnp.ndarray, tr: jnp.ndarray, rot: jnp.ndarray,
                     cam: CameraParam, mp: MapperParam, op: ObsGPParam,
                     chunk: int = 4096, blocked: bool = None,
                     nv_cap: int = None, obs_c_cap: int = None):
    """Fused tree-independent frame stages (see mapper2d.frame_compute_2d).

    nv_cap: pow2 bucket of the frame's valid-pixel count (host-known,
    api3d._host_gate) — routes the probe sweep through the compacted
    gather path (newmeas_3d nv_cap docstring). None keeps the dense
    blocked/gather sweeps.

    obs_c_cap: pow2 bucket of the frame's NONEMPTY obs-cell count
    (host-known, api3d._obs_cell_cap) — compacts the ObsGP2D fit's
    Cholesky pipeline to the cells that actually train
    (obsgp.fit_obsgp2d c_cap docstring).
    """
    if blocked is None:
        blocked = _obs_blocked_default()
    prep = preprocess_3d(depth, tr, rot, cam, mp)
    obs = obsgp.fit_obsgp2d(prep.v, prep.u, prep.zinv, op, c_cap=obs_c_cap)
    nm = newmeas_3d(obs, prep, rot, mp, op, chunk, cam=cam,
                    blocked=blocked, nv_cap=nv_cap)
    return prep, obs, nm


@jax.jit
def pack_frame_results(rv: Reeval3D, drop, nm: NewMeas3D) -> jnp.ndarray:
    """Flatten the per-frame host-pull payload into ONE f32 vector (one
    transfer instead of one per pytree leaf; see the 2D twin
    mapper2d.pack_frame_results)."""
    cols_rv = jnp.stack(
        [rv.action.astype(jnp.float32),
         rv.pos[:, 0], rv.pos[:, 1], rv.pos[:, 2],
         rv.grad[:, 0], rv.grad[:, 1], rv.grad[:, 2],
         rv.noise, rv.grad_noise,
         rv.dbl_pos_sig.astype(jnp.float32),
         rv.dbl_grad_sig.astype(jnp.float32)], axis=1)      # [K, 11]
    return jnp.concatenate([cols_rv.ravel(),
                            jnp.asarray(drop, jnp.float32).reshape(1),
                            pack_nm_only(nm)])


@jax.jit
def pack_nm_only(nm: NewMeas3D) -> jnp.ndarray:
    """New-measurement half of pack_frame_results."""
    cols = jnp.stack(
        [nm.insert_ok.astype(jnp.float32),
         nm.pos[:, 0], nm.pos[:, 1], nm.pos[:, 2],
         nm.grad[:, 0], nm.grad[:, 1], nm.grad[:, 2],
         nm.noise, nm.grad_noise], axis=1)                  # [P, 9]
    return cols.ravel()


def unpack_frame_results(flat, k: int, p: int):
    """Host-side split of pack_frame_results (numpy in, numpy out).
    Returns (Reeval3D | None, drop int, NewMeas3D)."""
    import numpy as np
    rv, drop = None, 0
    off = 0
    if k:
        a = np.asarray(flat[:k * 11]).reshape(k, 11)
        rv = Reeval3D(action=a[:, 0].astype(np.int32), pos=a[:, 1:4],
                      grad=a[:, 4:7], noise=a[:, 7], grad_noise=a[:, 8],
                      dbl_pos_sig=a[:, 9], dbl_grad_sig=a[:, 10])
        drop = int(flat[k * 11])
        off = k * 11 + 1
    b = np.asarray(flat[off:]).reshape(p, 9)
    nm = NewMeas3D(insert_ok=b[:, 0] > 0.5, pos=b[:, 1:4], grad=b[:, 4:7],
                   noise=b[:, 7], grad_noise=b[:, 8])
    return rv, drop, nm
