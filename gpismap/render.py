"""Sphere-traced rendering against the GPIS SDF, with autodiff.

The reference's only "rendering" is dense-grid evaluation + marching
squares/isosurface (matlab/visualize_gpisMap3.m; SURVEY.md §3.5). Here the
map's batched SDF oracle (models/cluster.py:map_test) drives a ray marcher
directly, and depth is differentiable end-to-end:

  * marching runs under stop_gradient (fixed-step lax.scan)
  * the returned depth applies one implicit-function correction
      t* = t_hat - f(o + t_hat d) / <grad f, d>
    which carries exact first-order gradients of the root of f along the
    ray — w.r.t. ray origins/directions AND the cluster-GP store arrays
    (support positions, targets, alpha), since map_test is pure jnp.

Pixel gradients flow through the GP posterior to sensor-point and
hyperparameter inputs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .models import cluster


class RenderConfig(NamedTuple):
    """Static SDF-oracle + marcher parameters (taken from the mapper)."""

    cell_size: float
    grid_half: int
    noff: int
    search_half: float
    scale: float
    val_const: float
    grad_const: float
    var_thre: float
    default_var: float
    tile: int
    max_cells: int
    max_active: int
    fbias: float
    n_steps: int = 48
    eps: float = 1e-3
    t_max: float = 10.0
    step_scale: float = 0.9
    two_phase: bool = False
    remat: bool = False
    flat_eval: bool = False


class Hyper(NamedTuple):
    """Traced GP hyperparameters for the SDF oracle.

    Overrides the static RenderConfig values so jax.grad can flow into the
    kernel length scale and variance constants (the reference's scale /
    noise hyperparameters, covFnc.cpp:29-33, params.h:73-93).
    """

    scale: jnp.ndarray
    val_const: jnp.ndarray
    grad_const: jnp.ndarray


def hyper_from_scale(scale, dim: int) -> Hyper:
    """Hyper with the dim-appropriate variance constants; grad_const
    tracks scale as 3/l^2 + const (OnGPIS.h:47,58)."""
    sc = jnp.asarray(scale, jnp.float32)
    vc = 1.001 if dim == 3 else 1.01
    gc = 3.0 / (sc * sc) + (0.001 if dim == 3 else 0.1)
    return Hyper(scale=sc, val_const=jnp.asarray(vc, jnp.float32),
                 grad_const=gc)


def config_from_mapper(m, **overrides) -> RenderConfig:
    is3d = m.dim == 3
    cfg = RenderConfig(
        cell_size=m.cell_size, grid_half=m.grid_half, noff=m._noff,
        search_half=m._search_half, scale=m.p.map_scale_param,
        val_const=1.001 if is3d else 1.01,
        grad_const=m.p.three_over_scale + (0.001 if is3d else 0.1),
        var_thre=m.p.test_var_thre,
        default_var=1.0 + m.p.map_noise_param,
        tile=m.cap.test_tile, max_cells=m.cap.max_cells,
        max_active=m.cap.test_active_cells, fbias=m.p.fbias,
        t_max=4.0 if is3d else 30.0,
        eps=1e-4 if is3d else 1e-3)
    return cfg._replace(**overrides) if overrides else cfg


def sdf_eval(store: cluster.ClusterStore, grid: jnp.ndarray, x: jnp.ndarray,
             cfg: RenderConfig, factors=None, hyper: Hyper | None = None):
    """(sdf, grad, var) at x [N, D]; sdf = posterior mean + fbias so the
    surface sits at sdf == 0 (the demo's +bias convention,
    visualize_gpisMap.m:26). Pass prefactorized cell factors (from
    cluster.factorize_slots) to avoid refactorizing per call — essential
    inside the marching loop. `hyper` (traced) overrides the static
    scale/variance constants for hyperparameter autodiff."""
    h = hyper or Hyper(scale=cfg.scale, val_const=cfg.val_const,
                       grad_const=cfg.grad_const)
    f, g, vf, _, _ = cluster.map_test(
        store, grid, x, cell_size=cfg.cell_size, grid_half=cfg.grid_half,
        noff=cfg.noff, search_half=cfg.search_half, scale=h.scale,
        val_const=h.val_const, grad_const=h.grad_const,
        var_thre=cfg.var_thre, default_var=cfg.default_var, tile=cfg.tile,
        max_cells=cfg.max_cells, max_active=cfg.max_active,
        factors=factors,
        two_phase=cfg.two_phase, remat=cfg.remat,
        flat_eval=cfg.flat_eval)
    return f + cfg.fbias, g, vf


@functools.partial(jax.jit, static_argnames=("cfg",))
def implicit_correct(store: cluster.ClusterStore, grid: jnp.ndarray,
                     origins: jnp.ndarray, dirs: jnp.ndarray,
                     t_hat: jnp.ndarray, cfg: RenderConfig, factors=None,
                     hyper: Hyper | None = None):
    """One differentiable implicit-function correction of a marched depth:
    t* = t_hat - f(o + t_hat d) / <grad f, d>.

    This is the ONLY differentiable evaluation of the render path (the
    march runs under stop_gradient); callers doing backward-heavy work
    (pixel-gradient training) can march the full ray set forward, then
    call this on the HIT rays only -- non-hit rays carry zero gradient
    for any hit-masked loss, so the compaction is exact and shrinks the
    backward program. Configured for autodiff: single-phase, FLAT tile
    evaluation (two_phase=False, flat_eval=True forced here) — the
    backward is then plain transposed einsums with no scan/cond to
    differentiate through, which keeps the 3D-production-shape gradient
    program small.

    Returns (t [N], f [N], g [N, D], vf [N]).
    """
    cfg = cfg._replace(two_phase=False, remat=True,
                       flat_eval=True)
    x_hat = origins + t_hat[:, None] * dirs
    f, g, vf = sdf_eval(store, grid, x_hat, cfg, factors, hyper)
    denom = jnp.sum(g * dirs, axis=-1)
    denom = jnp.where(jnp.abs(denom) > 1e-3, denom,
                      jnp.where(denom < 0, -1e-3, 1e-3))
    return t_hat - f / denom, f, g, vf


@functools.partial(jax.jit, static_argnames=("cfg",))
def sphere_trace(store: cluster.ClusterStore, grid: jnp.ndarray,
                 origins: jnp.ndarray, dirs: jnp.ndarray,
                 cfg: RenderConfig, factors=None,
                 hyper: Hyper | None = None):
    """March rays against the SDF; differentiable depth via implicit
    correction.

    origins/dirs: [N, D] (dirs unit). Returns dict with t [N] (corrected,
    differentiable), hit [N] bool, pos [N, D], normal [N, D] (posterior
    gradient, normalized), var [N], steps [N].

    `hyper` (traced) makes depth differentiable w.r.t. the GP scale and
    variance constants in addition to ray/store inputs.
    """
    n = origins.shape[0]

    # The march is non-differentiable BY DESIGN (the correction below
    # carries the exact implicit gradient), so sever every traced value
    # it reads — not just rays and t_hat. Leaving store/hyper traced
    # makes jax.grad differentiate through all n_steps scan iterations:
    # a 48x larger backward program.
    store_ng = jax.lax.stop_gradient(store)
    hyper_ng = None if hyper is None else jax.lax.stop_gradient(hyper)
    factors_ng = None if factors is None else jax.lax.stop_gradient(
        factors)

    def march(o, d):
        def body(carry, _):
            t, done, steps = carry
            x = o + t[:, None] * d
            f, _, vf = sdf_eval(store_ng, grid, x, cfg, factors_ng,
                                hyper_ng)
            hit = jnp.abs(f) < cfg.eps
            adv = jnp.where(done | hit, 0.0, cfg.step_scale * f)
            # unmapped space returns f = fbias -> fixed forward steps
            t_new = jnp.clip(t + adv, 0.0, cfg.t_max)
            done_new = done | hit | (t_new >= cfg.t_max)
            steps = steps + (~done).astype(jnp.int32)
            return (t_new, done_new, steps), None

        init = (jnp.zeros(n, origins.dtype), jnp.zeros(n, bool),
                jnp.zeros(n, jnp.int32))
        (t, done, steps), _ = jax.lax.scan(body, init, None,
                                           length=cfg.n_steps)
        return t, steps

    t_hat, steps = march(jax.lax.stop_gradient(origins),
                         jax.lax.stop_gradient(dirs))
    t_hat = jax.lax.stop_gradient(t_hat)

    # implicit-function correction: carries d t*/d(inputs); see
    # implicit_correct (the march above may run two-phase — it sits
    # under stop_gradient).
    t, f, g, vf = implicit_correct(store, grid, origins, dirs, t_hat, cfg,
                                   factors, hyper)
    hit = (jnp.abs(f) < 10.0 * cfg.eps) & (t_hat < cfg.t_max)
    pos = origins + t[:, None] * dirs
    nrm = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
    return dict(t=t, t_hat=t_hat, hit=hit, pos=pos, normal=nrm, var=vf,
                steps=steps)


def camera_rays(pose_tr, pose_rot, cam, subsample: int = 4):
    """Pinhole ray grid in world frame. Returns (origins [N,3], dirs [N,3],
    (h, w))."""
    import numpy as np

    rows = np.arange(0, cam.height, subsample)
    cols = np.arange(0, cam.width, subsample)
    v = (rows - cam.cy) / cam.fy
    u = (cols - cam.cx) / cam.fx
    uu, vv = np.meshgrid(u, v)
    d_cam = np.stack([uu, vv, np.ones_like(uu)], -1)
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    d_world = d_cam.reshape(-1, 3) @ np.asarray(pose_rot).T
    o = np.broadcast_to(np.asarray(pose_tr), d_world.shape)
    return (o.astype(np.float32), d_world.astype(np.float32),
            (len(rows), len(cols)))


def render_depth(mapper, pose_tr, pose_rot, cam=None, subsample: int = 4,
                 **cfg_overrides):
    """Render a depth/normal image from a mapper's current state."""
    import numpy as np

    cam = cam or getattr(mapper, "cam", None)
    cfg = config_from_mapper(mapper, **cfg_overrides)
    o, d, shape = camera_rays(pose_tr, pose_rot, cam, subsample)
    factors = mapper._get_factors() if hasattr(mapper, "_get_factors") \
        else None
    out = sphere_trace(mapper.store, mapper.grid, jnp.asarray(o),
                       jnp.asarray(d), cfg, factors)
    depth = np.asarray(out["t"]).reshape(shape)
    hit = np.asarray(out["hit"]).reshape(shape)
    normal = np.asarray(out["normal"]).reshape(shape + (3,))
    return dict(depth=np.where(hit, depth, np.nan), hit=hit, normal=normal,
                var=np.asarray(out["var"]).reshape(shape))
