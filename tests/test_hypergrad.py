"""Hyperparameter autodiff: gradients of the SDF posterior and of
sphere-traced depth w.r.t. the kernel length scale and observation noise.

The reference exposes scale/noise as compile-time constants
(covFnc.cpp:29-33, params.h:73-93); here they are traced scalars so
jax.grad flows end-to-end: noise/scale -> batched fit (retrain_cells) ->
factorization -> cross-covariance -> posterior / rendered depth.
"""
import numpy as np
import jax
import jax.numpy as jnp

from gpismap import render
from gpismap.config import CapacityParam
from gpismap.models import cluster


def _circle_support(n=40, m=16):
    """Support data for a unit-circle map, grouped into cluster cells."""
    from gpismap.config import TREE_2D
    from gpismap.runtime import SpatialIndex

    cap = CapacityParam(gp_support=m, retrain_batch=8, max_cells=64,
                        max_nodes=512, test_tile=16, test_active_cells=16,
                        max_beams=64)
    idx = SpatialIndex(2, TREE_2D, max_slots=cap.max_cells)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ids = idx.try_insert(pts)
    ok = ids >= 0
    normals = pts[ok] / np.linalg.norm(pts[ok], axis=1, keepdims=True)
    idx.set_node_data(ids[ok], np.full(ok.sum(), -0.2, np.float32),
                      np.full(ok.sum(), 0.02, np.float32), normals,
                      np.full(ok.sum(), 0.02, np.float32))
    rt = idx.collect_retrain(4.0, m, cap.max_cells)
    d = idx.dump_nodes()
    sup = rt["support"]
    supc = np.clip(sup, 0, None)
    cells = idx.all_cluster_cells()
    centers, _, slots = idx.cell_info(cells)
    grid = cluster.build_grid(np.floor(centers / 1.6).astype(np.int64),
                              slots, 2, 128)
    data = dict(slots=jnp.asarray(rt["slots"]),
                slot_ok=jnp.asarray(rt["slots"] >= 0),
                x=jnp.asarray(d["pos"][supc]),
                grad=jnp.asarray(d["grad"][supc]),
                val=jnp.asarray(d["val"][supc]),
                sigx=jnp.asarray(d["pos_sig"][supc]),
                siggrad=jnp.asarray(d["grad_sig"][supc]),
                valid=jnp.asarray(sup >= 0))
    return cap, data, grid


def _fit(cap, data, scale, noise_bump=0.0):
    store = cluster.make_store(cap, 2)
    return cluster.retrain_cells(
        store, data["slots"], data["slot_ok"], data["x"], data["grad"],
        data["val"], data["sigx"] + noise_bump,
        data["siggrad"] + noise_bump, data["valid"], scale)


def _cfg(cap):
    return render.RenderConfig(
        cell_size=1.6, grid_half=128, noff=4, search_half=4.8, scale=1.2,
        val_const=1.01, grad_const=3.0 / 1.44 + 0.1, var_thre=0.4,
        default_var=1.01, tile=cap.test_tile, max_cells=cap.max_cells,
        max_active=cap.test_active_cells, fbias=0.2, n_steps=24,
        eps=1e-3, t_max=6.0)


def _check_fd(fn, x0, h, rtol=0.05, atol=2e-2):
    g = float(jax.grad(fn)(jnp.asarray(x0, jnp.float32)))
    fp = float(fn(jnp.asarray(x0 + h, jnp.float32)))
    fm = float(fn(jnp.asarray(x0 - h, jnp.float32)))
    fd = (fp - fm) / (2 * h)
    assert np.isfinite(g), g
    err = abs(g - fd)
    assert err < max(rtol * abs(fd), atol), (g, fd)
    return g, fd


def test_sdf_grad_wrt_scale_and_noise():
    """d posterior-SDF / d scale and / d noise, FD-verified (f32)."""
    cap, data, grid = _circle_support()
    cfg = _cfg(cap)
    q = jnp.asarray([[1.5, 0.0], [0.0, 0.7], [-1.2, 0.4]], jnp.float32)

    def loss_scale(s):
        store = _fit(cap, data, s)
        f, _, vf = render.sdf_eval(store, grid, q, cfg,
                                   hyper=render.hyper_from_scale(s, 2))
        return jnp.sum(f) + jnp.sum(vf)

    g, fd = _check_fd(loss_scale, 1.2, 0.02)
    assert abs(g) > 1e-3, "scale gradient should be non-trivial"

    def loss_noise(nb):
        store = _fit(cap, data, jnp.asarray(1.2, jnp.float32), nb)
        f, _, vf = render.sdf_eval(
            store, grid, q, cfg,
            hyper=render.hyper_from_scale(jnp.asarray(1.2, jnp.float32), 2))
        return jnp.sum(f) + jnp.sum(vf)

    g, fd = _check_fd(loss_noise, 0.0, 5e-3)
    assert abs(g) > 1e-3, "noise gradient should be non-trivial"


def test_hypergrad_multidevice_allreduce():
    """Hyperparameter gradient across the mesh (SURVEY §5.8 backward
    story): the query batch is sharded over 8 devices, scale/store are
    replicated, and jax.grad of the data-parallel loss makes XLA insert
    the gradient all-reduce (psum over ICI on real chips). The
    multi-device gradient must equal the single-device gradient and the
    finite difference."""
    import jax as _jax
    import pytest
    if len(_jax.devices()) < 8:
        pytest.skip("need 8 devices")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gpismap.parallel import data_mesh

    cap, data, grid = _circle_support()
    cfg = _cfg(cap)
    mesh = data_mesh(jax.devices()[:8])
    sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    rep = NamedSharding(mesh, P())
    rng = np.random.default_rng(0)
    qh = np.asarray(rng.uniform(-1.5, 1.5, (64, 2)), np.float32)

    def make_loss(q, data_, grid_):
        def loss(s):
            store = cluster.retrain_cells(
                cluster.make_store(cap, 2), data_["slots"],
                data_["slot_ok"], data_["x"], data_["grad"], data_["val"],
                data_["sigx"], data_["siggrad"], data_["valid"], s)
            f, _, vf = render.sdf_eval(store, grid_, q, cfg,
                                       hyper=render.hyper_from_scale(s, 2))
            return jnp.sum(f) + jnp.sum(vf)
        return loss

    g1 = float(jax.grad(make_loss(jnp.asarray(qh), data, grid))(
        jnp.asarray(1.2, jnp.float32)))

    data8 = jax.device_put(data, rep)
    grid8 = jax.device_put(grid, rep)
    q8 = jax.device_put(jnp.asarray(qh), sh)
    loss8 = make_loss(q8, data8, grid8)
    g8, fd = _check_fd(loss8, 1.2, 0.02)
    np.testing.assert_allclose(g8, g1, rtol=1e-4, atol=1e-5)


def test_render_depth_grad_wrt_scale():
    """d rendered-depth / d scale through marching + implicit correction
    (the north-star hyperparameter-gradient path)."""
    cap, data, grid = _circle_support()
    cfg = _cfg(cap)
    # rays from outside toward the circle
    o = jnp.asarray([[3.0, 0.0], [0.0, 3.0], [-2.5, -1.0]], jnp.float32)
    d = -o / jnp.linalg.norm(o, axis=-1, keepdims=True)

    # fix the hit mask at the base scale so FD varies a smooth quantity
    base_store = _fit(cap, data, jnp.asarray(1.2, jnp.float32))
    base = render.sphere_trace(base_store, grid, o, d, cfg)
    w = jax.lax.stop_gradient(base["hit"].astype(jnp.float32))
    assert float(w.sum()) >= 2, "rays must hit the circle"

    def depth_loss(s):
        store = _fit(cap, data, s)
        out = render.sphere_trace(store, grid, o, d, cfg,
                                  hyper=render.hyper_from_scale(s, 2))
        return jnp.sum(out["t"] * w)

    g, fd = _check_fd(depth_loss, 1.2, 0.02)
