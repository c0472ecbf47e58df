"""2D online mapper — device-side computations.

The reference's per-node sequential pipeline (reference:
cpp/src/GPisMap.cpp:151-572) re-expressed as three batched, jitted stages:

  preprocess_2d  — range gating + polar->cartesian + rigid transform
                   (GPisMap.cpp:105-149)
  reeval_2d      — re-evaluate existing map nodes against the new scan:
                   occupancy test, iterative surface re-localization,
                   finite-difference normal, noise model, fusion
                   (GPisMap.cpp:235-455)
  newmeas_2d     — evaluate new surface candidates per beam
                   (GPisMap.cpp:466-572)

All loops over nodes/beams become array axes; the 10-step re-localization
runs in lockstep with per-node break masks (exactly the reference's break
conditions). Tree mutations implied by the outputs (remove / re-insert /
noise-double) are applied by the host runtime in reference order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapperParam, ObsGPParam
from ..ops.precision import matmul
from . import obsgp

# refinement-loop iteration cap and occupancy gates
# (GPisMap.cpp:264,279,304 — hard-coded TO-DOs in the reference)
_RELOC_ITERS = 10
_OCC_STOP = 0.02


def occ_test(rinv, rinv0, a):
    """Logistic occupancy proxy 2*(sigmoid(a*(rinv-rinv0)) - 0.5)
    (GPisMap.cpp:39-42)."""
    return 2.0 * (jax.nn.sigmoid(a * (rinv - rinv0)) - 0.5)


class Preproc2D(NamedTuple):
    valid: jnp.ndarray       # [N] range-gated beams
    theta: jnp.ndarray       # [N]
    rng: jnp.ndarray         # [N] raw ranges
    f: jnp.ndarray           # [N] 1/sqrt(range)
    xy_local: jnp.ndarray    # [N, 2] sensor-frame hit (no offset)
    xy_global: jnp.ndarray   # [N, 2] world-frame hit
    range_obs_max: jnp.ndarray  # scalar


@functools.partial(jax.jit, static_argnames=("mp",))
def preprocess_2d(theta: jnp.ndarray, rng: jnp.ndarray, tr: jnp.ndarray,
                  rot: jnp.ndarray, mp: MapperParam) -> Preproc2D:
    """Range gate + transforms (GPisMap.cpp:105-149).

    rot: [2, 2] world-from-sensor rotation; tr: [2].
    """
    valid = (rng > mp.min_range) & (rng < mp.max_range)
    f = 1.0 / jnp.sqrt(jnp.maximum(rng, 1e-12))
    xl = rng * jnp.cos(theta)
    yl = rng * jnp.sin(theta)
    loc = jnp.stack([xl, yl], -1)
    off = jnp.asarray(mp.sensor_offset, loc.dtype)
    glob = matmul(loc + off, rot.T) + tr
    rmax = jnp.max(jnp.where(valid, rng, 0.0))
    return Preproc2D(valid=valid, theta=theta, rng=rng, f=f, xy_local=loc,
                     xy_global=glob, range_obs_max=rmax)


class Reeval2D(NamedTuple):
    """Per-node outcome. action: 0 keep, 1 double-noise, 2 remove,
    3 remove+reinsert."""

    action: jnp.ndarray      # [K] int32
    pos: jnp.ndarray         # [K, 2] new world position (action 3)
    grad: jnp.ndarray        # [K, 2] new world normal (action 3)
    noise: jnp.ndarray       # [K] new position noise (action 3)
    grad_noise: jnp.ndarray  # [K]
    dbl_pos_sig: jnp.ndarray   # [K] doubled noises (action 1)
    dbl_grad_sig: jnp.ndarray  # [K]


@functools.partial(jax.jit, static_argnames=("mp", "op", "chunk"))
def reeval_2d(obs: obsgp.ObsGP1DState, pos: jnp.ndarray, grad: jnp.ndarray,
              pos_sig: jnp.ndarray, grad_sig: jnp.ndarray,
              valid: jnp.ndarray, tr: jnp.ndarray, rot: jnp.ndarray,
              mp: MapperParam, op: ObsGPParam,
              chunk: int = 1024) -> Reeval2D:
    """Batched reEvalPoints (GPisMap.cpp:235-455)."""
    k = pos.shape[0]
    off = jnp.asarray(mp.sensor_offset, pos.dtype)

    def to_local(world):
        return matmul(world - tr, rot) - off

    def obs_at(xy):
        ang = jnp.arctan2(xy[..., 1], xy[..., 0])
        r = jnp.sqrt(jnp.sum(xy * xy, -1))
        m, v = obsgp.obsgp1d_test(obs, ang.reshape(-1), op, chunk)
        return m.reshape(ang.shape), v.reshape(ang.shape), r

    loc = to_local(pos)
    rinv0, var, r = obs_at(loc)
    gate = valid & (var <= mp.obs_var_thre)
    oc0 = occ_test(1.0 / jnp.sqrt(jnp.maximum(r, 1e-12)), rinv0, r * 30.0)
    active = gate & (oc0 >= -0.1)                  # GPisMap.cpp:258-265
    grad_loc = matmul(grad, rot)                         # world -> sensor frame

    # --- iterative re-localization (GPisMap.cpp:273-315) ---
    def body(i, st):
        x_new, dx, oc, abs_oc, r_new, cont = st
        step = jnp.where(oc[:, None] < 0, 1.0, -1.0) * grad_loc * dx[:, None]
        x_new = jnp.where(cont[:, None], x_new + step, x_new)
        rinv0_n, var_n, r_t = obs_at(x_new)
        r_new = jnp.where(cont, r_t, r_new)
        brk_var = var_n > mp.obs_var_thre
        oc_n = occ_test(1.0 / jnp.sqrt(jnp.maximum(r_t, 1e-12)), rinv0_n,
                        r_t * 30.0)
        brk_oc = (jnp.abs(oc_n) < _OCC_STOP) | (oc < -0.1)
        upd = cont & ~brk_var & ~brk_oc
        flip = oc * oc_n < 0.0
        dx = jnp.where(upd, jnp.where(flip, 0.5 * dx, 1.1 * dx), dx)
        oc = jnp.where(upd, oc_n, oc)
        abs_oc = jnp.where(upd, jnp.abs(oc_n), abs_oc)
        cont = upd & (jnp.abs(oc_n) > _OCC_STOP)
        return x_new, dx, oc, abs_oc, r_new, cont

    abs0 = jnp.abs(oc0)
    st0 = (loc, jnp.full((k,), mp.delx, pos.dtype), oc0, abs0, r,
           active & (abs0 > _OCC_STOP))
    x_new, _, _, abs_oc, r_new, _ = jax.lax.fori_loop(0, _RELOC_ITERS, body,
                                                      st0)

    # --- 4-probe normal + noise model (GPisMap.cpp:317-380) ---
    pert = jnp.asarray([[1., 0.], [-1., 0.], [0., 1.], [0., -1.]],
                       pos.dtype) * mp.delx
    ppos = x_new[:, None, :] + pert[None]          # [K, 4, 2]
    prinv0, pvar, pr = obs_at(ppos)
    probe_ok = jnp.all(pvar <= mp.obs_var_thre, axis=-1)
    pocc = occ_test(1.0 / jnp.sqrt(jnp.maximum(pr, 1e-12)), prinv0,
                    pr * 30.0)
    occ_mean = 0.25 * jnp.sum(pocc, -1)
    r0 = 1.0 / jnp.maximum(prinv0 * prinv0, 1e-12)
    r0_sqr_sum = jnp.sum(r0 * r0, -1)
    r0_mean = 0.25 * jnp.sum(r0, -1)

    act2 = active & probe_ok
    gnl = jnp.stack([pocc[:, 0] - pocc[:, 1], pocc[:, 2] - pocc[:, 3]],
                    -1) / mp.delx
    norm_g = jnp.sqrt(jnp.sum(gnl * gnl, -1))
    dbl = act2 & (norm_g < 1e-3)                   # GPisMap.cpp:354-357
    act3 = act2 & (norm_g >= 1e-3)

    r_var = (r0_sqr_sum / 3.0 - r0_mean * r0_mean * 4.0 / 3.0) / mp.delx
    gnl_n = gnl / jnp.maximum(norm_g, 1e-12)[:, None]
    noise = mp.min_position_noise * jnp.clip(r_new * r_new, 1.0, 100.0)
    grad_noise = jnp.clip(jnp.abs(occ_mean) + r_var, mp.min_grad_noise, 1.0)
    dist = jnp.sqrt(jnp.sum(x_new * x_new, -1))
    view_ang = jnp.maximum(
        -jnp.sum(x_new * gnl_n, -1) / jnp.maximum(dist, 1e-12), 0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise = noise + view_noise + abs_oc
    grad_noise = grad_noise + 0.1 * view_noise

    pos_new = matmul(x_new + off, rot.T) + tr
    grad_new = matmul(gnl_n, rot.T)

    # --- fusion with the old estimate (GPisMap.cpp:391-421) ---
    fuse = grad_sig <= 0.5
    psum = pos_sig + noise
    pos_f = (noise[:, None] * pos + pos_sig[:, None] * pos_new) / psum[:, None]
    dist_f = 0.5 * jnp.sqrt(jnp.sum((pos - pos_f) ** 2, -1))
    tv_x = grad[:, 0] * grad_new[:, 0] + grad[:, 1] * grad_new[:, 1]
    tv_y = -grad[:, 1] * grad_new[:, 0] + grad[:, 0] * grad_new[:, 1]
    angd = jnp.arctan2(tv_y, tv_x) * noise / psum
    ca, sa = jnp.cos(angd), jnp.sin(angd)
    grad_f = jnp.stack([ca * grad[:, 0] - sa * grad[:, 1],
                        sa * grad[:, 0] + ca * grad[:, 1]], -1)
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

    discard = (noise_out > 1.0) & (gnoise_out > 0.61)  # GPisMap.cpp:425
    action = jnp.where(
        dbl, 1, jnp.where(act3 & discard, 2,
                          jnp.where(act3, 3, 0))).astype(jnp.int32)
    return Reeval2D(action=action, pos=pos_out, grad=grad_out,
                    noise=noise_out, grad_noise=gnoise_out,
                    dbl_pos_sig=2.0 * pos_sig, dbl_grad_sig=2.0 * grad_sig)


class NewMeas2D(NamedTuple):
    insert_ok: jnp.ndarray   # [N] beam produces a new surface node
    pos: jnp.ndarray         # [N, 2] world position
    grad: jnp.ndarray        # [N, 2] world normal (or raw local, see quirk)
    noise: jnp.ndarray       # [N]
    grad_noise: jnp.ndarray  # [N]


@functools.partial(jax.jit, static_argnames=("mp", "op", "chunk"))
def newmeas_2d(obs: obsgp.ObsGP1DState, prep: Preproc2D, rot: jnp.ndarray,
               mp: MapperParam, op: ObsGPParam,
               chunk: int = 1024) -> NewMeas2D:
    """Batched evalPoints (GPisMap.cpp:466-572).

    The reference inserts each candidate before probing and removes it if a
    probe fails (GPisMap.cpp:490-534); probe outcomes are independent of the
    tree, so here insert_ok pre-filters and the host inserts winners only.
    """
    n = prep.theta.shape[0]
    _, var0 = obsgp.obsgp1d_test(obs, prep.theta, op, chunk)
    gate = prep.valid & (var0 <= mp.obs_var_thre)

    pert = jnp.asarray([[1., 0.], [-1., 0.], [0., 1.], [0., -1.]],
                       prep.xy_local.dtype) * mp.delx
    ppos = prep.xy_local[:, None, :] + pert[None]
    ang = jnp.arctan2(ppos[..., 1], ppos[..., 0])
    pr = jnp.sqrt(jnp.sum(ppos * ppos, -1))
    prinv0, pvar = obsgp.obsgp1d_test(obs, ang.reshape(-1), op, chunk)
    prinv0 = prinv0.reshape(n, 4)
    pvar = pvar.reshape(n, 4)
    probe_ok = jnp.all(pvar <= mp.obs_var_thre, axis=-1)
    pocc = occ_test(1.0 / jnp.sqrt(jnp.maximum(pr, 1e-12)), prinv0,
                    pr * 30.0)
    occ_mean = 0.25 * jnp.sum(pocc, -1)

    graw = jnp.stack([pocc[:, 0] - pocc[:, 1], pocc[:, 2] - pocc[:, 3]],
                     -1) / mp.delx
    norm2 = jnp.sum(graw * graw, -1)
    hasg = norm2 > 1e-6                            # GPisMap.cpp:544-545
    norm = jnp.sqrt(jnp.maximum(norm2, 1e-24))
    gl = graw / norm[:, None]
    gglob = matmul(gl, rot.T)

    noise_g = mp.min_position_noise * jnp.clip(prep.rng * prep.rng, 1.0,
                                               100.0)
    gnoise_g = jnp.clip(jnp.abs(occ_mean), mp.min_grad_noise, 1.0)
    dist = jnp.sqrt(jnp.sum(prep.xy_local ** 2, -1))
    view_ang = jnp.maximum(
        -jnp.sum(prep.xy_local * gl, -1) / jnp.maximum(dist, 1e-12), 0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise_g = noise_g + view_noise

    # reference quirk kept: gradient-free candidates store the raw local
    # occupancy difference un-normalized/un-rotated with noise 100/1.0
    # (GPisMap.cpp:538-560)
    grad_out = jnp.where(hasg[:, None], gglob, graw)
    noise = jnp.where(hasg, noise_g, 100.0)
    gnoise = jnp.where(hasg, gnoise_g, 1.0)
    return NewMeas2D(insert_ok=gate & probe_ok, pos=prep.xy_global,
                     grad=grad_out, noise=noise, grad_noise=gnoise)


@functools.partial(jax.jit, static_argnames=("mp", "op", "g_max", "chunk"))
def frame_compute_2d(theta: jnp.ndarray, rng: jnp.ndarray, tr: jnp.ndarray,
                     rot: jnp.ndarray, mp: MapperParam, op: ObsGPParam,
                     g_max: int, chunk: int = 1024):
    """Fused tree-independent frame stages: preprocess + observation-GP
    fit + new-measurement evaluation in ONE dispatch."""
    prep = preprocess_2d(theta, rng, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=g_max)
    nm = newmeas_2d(obs, prep, rot, mp, op, chunk)
    return prep, obs, nm


@functools.partial(jax.jit, static_argnames=("mp", "op", "g_max", "chunk"))
def frame_update_2d(theta: jnp.ndarray, rng: jnp.ndarray, tr: jnp.ndarray,
                    rot: jnp.ndarray, node_pos: jnp.ndarray,
                    node_grad: jnp.ndarray, node_ps: jnp.ndarray,
                    node_gs: jnp.ndarray, node_valid: jnp.ndarray,
                    mp: MapperParam, op: ObsGPParam, g_max: int,
                    chunk: int = 1024):
    """The ENTIRE per-frame device compute in one dispatch: preprocess,
    obs-GP fit, batched re-evaluation of the host-gathered in-view nodes,
    and new-measurement evaluation. Used by the non-strict 2D path to get
    the update loop down to two device calls per frame (this + retrain)."""
    prep = preprocess_2d(theta, rng, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=g_max)
    rv = reeval_2d(obs, node_pos, node_grad, node_ps, node_gs, node_valid,
                   tr, rot, mp, op, chunk)
    nm = newmeas_2d(obs, prep, rot, mp, op, chunk)
    return rv, nm


@jax.jit
def pack_frame_results(rv: Reeval2D, nm: NewMeas2D) -> jnp.ndarray:
    """Flatten the per-frame host-pull payload into ONE f32 vector.

    device_get transfers each pytree leaf separately; one packed array is
    one transfer, and the host splits it back (unpack_frame_results). All fields are exactly representable in
    f32 (action in 0..3, bools as 0/1).
    """
    cols_rv = jnp.stack(
        [rv.action.astype(jnp.float32),
         rv.pos[:, 0], rv.pos[:, 1], rv.grad[:, 0], rv.grad[:, 1],
         rv.noise, rv.grad_noise,
         rv.dbl_pos_sig.astype(jnp.float32),
         rv.dbl_grad_sig.astype(jnp.float32)], axis=1)       # [K, 9]
    return jnp.concatenate([cols_rv.ravel(), pack_nm_only(nm)])


@jax.jit
def pack_nm_only(nm: NewMeas2D) -> jnp.ndarray:
    """New-measurement half of pack_frame_results (frames with no
    in-view nodes)."""
    cols = jnp.stack(
        [nm.insert_ok.astype(jnp.float32),
         nm.pos[:, 0], nm.pos[:, 1], nm.grad[:, 0], nm.grad[:, 1],
         nm.noise, nm.grad_noise], axis=1)                   # [N, 7]
    return cols.ravel()


def unpack_frame_results(flat, k: int, nb: int):
    """Host-side split of pack_frame_results (numpy in, numpy out).
    Returns (Reeval2D | None, NewMeas2D)."""
    import numpy as np
    rv = None
    if k:
        a = np.asarray(flat[:k * 9]).reshape(k, 9)
        rv = Reeval2D(action=a[:, 0].astype(np.int32), pos=a[:, 1:3],
                      grad=a[:, 3:5], noise=a[:, 5], grad_noise=a[:, 6],
                      dbl_pos_sig=a[:, 7], dbl_grad_sig=a[:, 8])
    b = np.asarray(flat[k * 9:]).reshape(nb, 7)
    nm = NewMeas2D(insert_ok=b[:, 0] > 0.5, pos=b[:, 1:3],
                   grad=b[:, 3:5], noise=b[:, 5], grad_noise=b[:, 6])
    return rv, nm
