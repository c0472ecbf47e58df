"""Sphere tracing + differentiable depth on a synthetic circle map."""
import numpy as np
import jax
import jax.numpy as jnp

from gpismap.config import CapacityParam, TREE_2D
from gpismap.models import cluster
from gpismap.render import RenderConfig, sdf_eval, sphere_trace
from gpismap.runtime import SpatialIndex


def _circle_map():
    cap = CapacityParam(gp_support=32, retrain_batch=16, max_cells=128,
                        max_nodes=1024, test_tile=32, test_active_cells=32,
                        max_beams=64)
    idx = SpatialIndex(2, TREE_2D, max_slots=cap.max_cells)
    ang = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ids = idx.try_insert(pts)
    ok = ids >= 0
    normals = pts[ok] / np.linalg.norm(pts[ok], axis=1, keepdims=True)
    idx.set_node_data(ids[ok], np.full(ok.sum(), -0.2, np.float32),
                      np.full(ok.sum(), 0.02, np.float32), normals,
                      np.full(ok.sum(), 0.02, np.float32))
    rt = idx.collect_retrain(4.0, cap.gp_support, cap.max_cells)
    d = idx.dump_nodes()
    sup = rt["support"]
    valid = sup >= 0
    supc = np.clip(sup, 0, None)
    store = cluster.make_store(cap, 2)
    store = cluster.retrain_cells(
        store, jnp.asarray(rt["slots"]), jnp.asarray(rt["slots"] >= 0),
        jnp.asarray(d["pos"][supc]), jnp.asarray(d["grad"][supc]),
        jnp.asarray(d["val"][supc]), jnp.asarray(d["pos_sig"][supc]),
        jnp.asarray(d["grad_sig"][supc]), jnp.asarray(valid), 1.2)
    cells = idx.all_cluster_cells()
    centers, _, slots = idx.cell_info(cells)
    coords = np.floor(centers / 1.6).astype(np.int64)
    grid = cluster.build_grid(coords, slots, 2, 128)
    cfg = RenderConfig(cell_size=1.6, grid_half=128, noff=4,
                       search_half=4.8, scale=1.2, val_const=1.01,
                       grad_const=3.0 / 1.44 + 0.1, var_thre=0.4,
                       default_var=1.01, tile=cap.test_tile,
                       max_cells=cap.max_cells,
                       max_active=cap.test_active_cells, fbias=0.2,
                       n_steps=48, eps=1e-3, t_max=6.0)
    return store, grid, cfg


def test_sphere_trace_hits_circle():
    store, grid, cfg = _circle_map()
    # rays from outside, pointing at the circle center
    origins = np.array([[3.0, 0.0], [0.0, 2.5], [-2.0, -2.0]], np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=1, keepdims=True)
    out = sphere_trace(store, grid, jnp.asarray(origins), jnp.asarray(dirs),
                       cfg)
    t = np.asarray(out["t"])
    hit = np.asarray(out["hit"])
    assert hit.all()
    expected = np.linalg.norm(origins, axis=1) - 1.0
    np.testing.assert_allclose(t, expected, atol=0.05)
    # normals point outward (against the ray)
    nrm = np.asarray(out["normal"])
    pos = np.asarray(out["pos"])
    cosang = np.sum(nrm * pos / np.linalg.norm(pos, axis=1, keepdims=True),
                    axis=1)
    assert np.all(cosang > 0.95)


def test_depth_gradient_wrt_origin():
    store, grid, cfg = _circle_map()
    d = jnp.asarray([[-1.0, 0.0]], jnp.float32)

    def depth_of_x0(x0):
        o = jnp.stack([x0, jnp.zeros_like(x0)], -1)[None].reshape(1, 2)
        out = sphere_trace(store, grid, o, d, cfg)
        return out["t"][0]

    x0 = jnp.asarray(3.0, jnp.float32)
    g = jax.grad(depth_of_x0)(x0)
    # moving the origin +dx away adds exactly +dx of depth
    fd = (depth_of_x0(x0 + 0.02) - depth_of_x0(x0 - 0.02)) / 0.04
    np.testing.assert_allclose(float(g), 1.0, atol=0.05)
    np.testing.assert_allclose(float(g), float(fd), atol=0.05)


def test_hit_compacted_correction_gradient_matches_full():
    """The production 3D backward recipe (render.implicit_correct over
    hit rays only) must give the same gradients as differentiating the
    full sphere_trace for a hit-masked loss — non-hit rays carry zero
    gradient by construction."""
    from gpismap.render import implicit_correct

    store, grid, cfg = _circle_map()
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False).astype(np.float32)
    origins = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang)], -1)
    dirs = -origins / np.linalg.norm(origins, axis=1, keepdims=True)
    # a couple of rays that miss (point away)
    origins = np.concatenate([origins, origins[:2]], 0).astype(np.float32)
    dirs = np.concatenate([dirs, -dirs[:2]], 0).astype(np.float32)
    o_d, d_d = jnp.asarray(origins), jnp.asarray(dirs)

    def loss_full(alpha):
        out = sphere_trace(store._replace(alpha=alpha), grid, o_d, d_d,
                           cfg)
        return jnp.sum(jnp.where(out["hit"], out["t"], 0.0))

    g_full = np.asarray(jax.grad(loss_full)(store.alpha))

    out = sphere_trace(store, grid, o_d, d_d, cfg)
    hit = np.asarray(out["hit"])
    t_hat = np.asarray(out["t_hat"])
    idx = np.nonzero(hit)[0]
    hpad = 16
    sel = np.zeros(hpad, np.int64)
    sel[:len(idx)] = idx
    w = np.zeros(hpad, np.float32)
    w[:len(idx)] = 1.0

    def loss_hits(alpha):
        t, _, _, _ = implicit_correct(
            store._replace(alpha=alpha), grid, jnp.asarray(origins[sel]),
            jnp.asarray(dirs[sel]), jnp.asarray(t_hat[sel]), cfg)
        return jnp.sum(jnp.asarray(w) * t)

    g_hits = np.asarray(jax.grad(loss_hits)(store.alpha))
    assert len(idx) >= 8            # the aimed rays all hit
    np.testing.assert_allclose(g_hits, g_full, rtol=1e-5, atol=1e-6)


def test_depth_gradient_through_gp_training():
    # the north-star path: pixel depth gradients flow through the GP
    # posterior (fit included) back to the sensor/surface sample values
    store, grid, cfg = _circle_map()
    o = jnp.asarray([[3.0, 0.0]], jnp.float32)
    d = jnp.asarray([[-1.0, 0.0]], jnp.float32)

    def depth_of_vals(val):
        st = cluster.retrain_cells(
            store, jnp.arange(store.trained.shape[0], dtype=jnp.int32),
            store.trained, store.x, store.grad, val, store.sigx,
            store.siggrad, store.valid, cfg.scale)
        return sphere_trace(st, grid, o, d, cfg)["t"][0]

    g = jax.grad(depth_of_vals)(store.val)
    gn = np.asarray(g)
    assert np.isfinite(gn).all()
    assert np.abs(gn).sum() > 0.0
    # finite-difference check on the largest-gradient entry
    i = np.unravel_index(np.abs(gn).argmax(), gn.shape)
    h = 1e-3
    vp = store.val.at[i].add(h)
    vm = store.val.at[i].add(-h)
    fd = (depth_of_vals(vp) - depth_of_vals(vm)) / (2 * h)
    np.testing.assert_allclose(gn[i], float(fd), rtol=0.1, atol=1e-3)
