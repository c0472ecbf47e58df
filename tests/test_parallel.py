"""Sharded execution on the 8-virtual-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest


def _need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"need {n} devices")


def _circle_map():
    """Unit-circle cluster-GP map (store, grid, map_test kwargs) shared by
    the sharded-vs-single tests."""
    from gpismap.config import CapacityParam, TREE_2D
    from gpismap.models import cluster
    from gpismap.runtime import SpatialIndex

    cap = CapacityParam(gp_support=16, retrain_batch=8, max_cells=64,
                        max_nodes=512, test_tile=16, test_active_cells=16,
                        max_beams=64)
    idx = SpatialIndex(2, TREE_2D, max_slots=cap.max_cells)
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
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
    supc = np.clip(sup, 0, None)
    store = cluster.make_store(cap, 2)
    store = cluster.retrain_cells(
        store, jnp.asarray(rt["slots"]), jnp.asarray(rt["slots"] >= 0),
        jnp.asarray(d["pos"][supc]), jnp.asarray(d["grad"][supc]),
        jnp.asarray(d["val"][supc]), jnp.asarray(d["pos_sig"][supc]),
        jnp.asarray(d["grad_sig"][supc]), jnp.asarray(sup >= 0), 1.2)
    cells = idx.all_cluster_cells()
    centers, _, slots = idx.cell_info(cells)
    grid = cluster.build_grid(np.floor(centers / 1.6).astype(np.int64),
                              slots, 2, 128)
    kw = dict(cell_size=1.6, grid_half=128, noff=4, search_half=4.8,
              scale=1.2, val_const=1.01, grad_const=3.0 / 1.44 + 0.1,
              var_thre=0.4, default_var=1.01, tile=cap.test_tile,
              max_cells=cap.max_cells, max_active=cap.test_active_cells)
    return store, grid, kw


def test_sharded_map_test_matches_single():
    _need_devices(8)
    from gpismap.models import cluster
    from gpismap.parallel import data_mesh, sharded_map_test

    store, grid, kw = _circle_map()
    q = np.asarray(np.random.default_rng(0).uniform(-2, 2, (64, 2)),
                   np.float32)

    f1, g1, v1, _, _ = cluster.map_test(store, grid, jnp.asarray(q), **kw)
    mesh = data_mesh(jax.devices()[:8])
    f8, g8, v8, _, _ = sharded_map_test(store, grid, jnp.asarray(q), mesh,
                                        **kw)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f8), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v8), rtol=1e-5,
                               atol=1e-5)


def _mesh8():
    from gpismap.parallel import data_mesh
    return data_mesh(jax.devices()[:8])


def test_mapper2d_sharded_matches_single():
    """The REAL online loop (host index + sharded reeval/newmeas/retrain/
    test) on the 8-device mesh vs single-device — same node set, fields
    equal to f32 collective-reduction tolerance."""
    _need_devices(8)
    from gpismap import datasets
    from gpismap.api import GPisMap2D
    from workloads import frames_2d

    m1 = GPisMap2D()
    m8 = GPisMap2D(mesh=_mesh8())
    for fr in frames_2d(4):
        m1.update(*fr)
        m8.update(*fr)
    assert m1.num_nodes == m8.num_nodes

    q = datasets.gazebo_test_grid()[0][::16]
    r1 = m1.test(q)
    r8 = m8.test(q)
    np.testing.assert_allclose(r1, r8, rtol=1e-4, atol=5e-4)


def test_mapper2d_sharded_full_sequence_golden():
    """The full 28-frame generated sequence through update_batch on the
    8-device mesh vs a single device, at the repository's parity bounds
    (mapped agreement, median and p95 |df|): over a whole sequence the
    two runs' reduction orders may flip a threshold somewhere, so the
    bound is statistical, as against the reference."""
    _need_devices(8)
    from gpismap import datasets
    from gpismap.api import GPisMap2D
    from workloads import frames_2d

    frames = frames_2d(28)
    xtest = datasets.gazebo_test_grid()[0][::16]
    m1 = GPisMap2D()
    m1.update_batch(frames)
    ref = m1.test(xtest)
    m = GPisMap2D(mesh=_mesh8())
    m.update_batch(frames)
    res = m.test(xtest)

    mapped_ref = ref[:, 3] < 1.0
    mapped = res[:, 3] < 1.0
    agree = (mapped_ref == mapped).mean()
    assert agree > 0.995, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    df = np.abs(res[both, 0] - ref[both, 0])
    assert np.median(df) < 2e-3, np.median(df)
    assert np.percentile(df, 95) < 2e-2, np.percentile(df, 95)


@pytest.mark.slow
def test_mapper3d_sharded_four_frames_golden():
    """GPisMap3D(mesh=...) over 4 generated frames vs a single device —
    the 3D twin of test_mapper2d_sharded_full_sequence_golden (the
    reference threads both mappers, GPisMap3.cpp:720-792,904-949).
    Exercises the 3D sharded reeval/retrain paths and _retrain_store's
    mesh bucket floor."""
    _need_devices(8)
    from gpismap import datasets
    from gpismap.api3d import GPisMap3D
    from workloads import CAP_3D_SMALL, frames_3d

    frames = frames_3d(4)
    xtest = datasets.bigbird_test_grid()[0][::16]
    m1 = GPisMap3D(cap=CAP_3D_SMALL)
    m1.update_batch(frames)
    ref = m1.test(xtest)
    m = GPisMap3D(cap=CAP_3D_SMALL, mesh=_mesh8())
    assert m.reeval_mode == "hybrid"
    m.update_batch(frames)
    assert abs(m.num_nodes - m1.num_nodes) <= max(3, m1.num_nodes // 100)
    res = m.test(xtest)
    mapped_ref = ref[:, 4] < 1.0
    mapped = res[:, 4] < 1.0
    agree = (mapped_ref == mapped).mean()
    assert agree > 0.995, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    df = np.abs(res[both, 0] - ref[both, 0])
    assert np.median(df) < 2e-3, np.median(df)
    assert np.percentile(df, 95) < 2e-2


def test_sharded_render_matches_single():
    """sphere_trace with the ray batch sharded over the 8-device mesh
    equals the single-device render (the north star's 'rays/s scaling'
    path; store/grid/factors replicated, rays data-parallel)."""
    _need_devices(8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpismap import render
    from gpismap.parallel import data_mesh

    store, grid, kw = _circle_map()
    cfg = render.RenderConfig(
        cell_size=kw["cell_size"], grid_half=kw["grid_half"],
        noff=kw["noff"], search_half=kw["search_half"], scale=kw["scale"],
        val_const=kw["val_const"], grad_const=kw["grad_const"],
        var_thre=kw["var_thre"], default_var=kw["default_var"],
        tile=kw["tile"], max_cells=kw["max_cells"],
        max_active=kw["max_active"], fbias=0.2, n_steps=24, t_max=6.0)

    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    o = 3.0 * np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)

    r1 = render.sphere_trace(store, grid, jnp.asarray(o), jnp.asarray(d),
                             cfg)
    # rays from radius 3 inward hit the unit circle at t ~ 2
    hit1 = np.asarray(r1["hit"])
    assert hit1.mean() > 0.9
    np.testing.assert_allclose(np.asarray(r1["t"])[hit1], 2.0, atol=0.05)

    mesh = data_mesh(jax.devices()[:8])
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    r8 = render.sphere_trace(
        jax.device_put(store, rep), jax.device_put(grid, rep),
        jax.device_put(jnp.asarray(o), sh), jax.device_put(jnp.asarray(d),
                                                           sh), cfg)
    np.testing.assert_allclose(np.asarray(r1["t"]), np.asarray(r8["t"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(r1["hit"]),
                                  np.asarray(r8["hit"]))
    np.testing.assert_allclose(np.asarray(r1["normal"]),
                               np.asarray(r8["normal"]), rtol=1e-4,
                               atol=1e-4)


def test_retrain_size_buckets_exact():
    """A small-bucket fit (mb < M) scattered into the store equals the
    full-padding fit exactly (masked identity rows)."""
    from gpismap.config import CapacityParam
    from gpismap.models import cluster

    rng = np.random.default_rng(3)
    cap = CapacityParam(gp_support=16, retrain_batch=8, max_cells=32,
                        max_nodes=256, test_tile=16, test_active_cells=16,
                        max_beams=64)
    b, mb = 4, 8                     # bucket size < store capacity 16
    x = rng.uniform(-1, 1, (b, cap.gp_support, 2)).astype(np.float32)
    g = rng.normal(size=(b, cap.gp_support, 2)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    val = np.full((b, cap.gp_support), -0.2, np.float32)
    ps = np.full((b, cap.gp_support), 0.05, np.float32)
    gs = np.full((b, cap.gp_support), 0.05, np.float32)
    valid = np.zeros((b, cap.gp_support), bool)
    valid[:, :6] = True              # all cells fit in the small bucket
    x[~valid] = 0.0

    slots = jnp.arange(b, dtype=jnp.int32)
    ok = jnp.ones(b, bool)
    s_full = cluster.retrain_cells(
        cluster.make_store(cap, 2), slots, ok, jnp.asarray(x),
        jnp.asarray(g), jnp.asarray(val), jnp.asarray(ps), jnp.asarray(gs),
        jnp.asarray(valid), 1.2)
    s_bkt = cluster.retrain_cells(
        cluster.make_store(cap, 2), slots, ok, jnp.asarray(x[:, :mb]),
        jnp.asarray(g[:, :mb]), jnp.asarray(val[:, :mb]),
        jnp.asarray(ps[:, :mb]), jnp.asarray(gs[:, :mb]),
        jnp.asarray(valid[:, :mb]), 1.2)
    np.testing.assert_allclose(np.asarray(s_full.alpha),
                               np.asarray(s_bkt.alpha), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(s_full.valid),
                                  np.asarray(s_bkt.valid))


def test_multihost_helpers():
    """multihost.initialize is a no-op single-process; global_query_array
    assembles a sharded global batch from process-local data."""
    _need_devices(8)
    from gpismap.parallel import multihost

    multihost.initialize()           # single process: must not raise
    mesh = _mesh8()
    local = np.arange(64, dtype=np.float32).reshape(32, 2)
    arr = multihost.global_query_array(mesh, local)
    assert arr.shape == (32, 2)      # single process: local == global
    np.testing.assert_allclose(np.asarray(arr), local)
