"""Incremental factor-cache maintenance (api._refresh_factors).

The reference keeps each cluster cell's Cholesky factor alive between
updates and swaps in a fresh one only when the cell retrains
(OnGPIS.h `L`; quadtree.cpp:438-441). The incremental cache must be
indistinguishable from a from-scratch factorization of the live set.
"""
import numpy as np
import jax.numpy as jnp

from workloads import CAP_3D_SMALL, frames_2d, frames_3d


def _fresh_factors(m):
    from gpismap.models import cluster

    live = m._live_slots()
    pad = np.full(m.cap.test_active_cells, -1, np.int32)
    pad[:len(live)] = live
    return cluster.factorize_slots(m.store, jnp.asarray(pad),
                                   m.p.map_scale_param,
                                   m.cap.test_active_cells)


def test_incremental_factor_cache_matches_fresh():
    from gpismap.api import GPisMap2D

    m = GPisMap2D()
    fr = frames_2d(1)[0]
    m.update(*fr)
    q = np.asarray(np.random.default_rng(0).uniform(-3, 3, (32, 2)),
                   np.float32) + fr[2][:2]
    m.test(q)                       # fills the cache
    assert m._factors is not None
    uniq_before = m._factors[1]

    # re-ingesting the same scan dedups every insert -> slot set unchanged
    # -> the retrain must refresh the cache incrementally, not drop it
    m.update(*fr)
    assert m._factors is not None, "incremental path did not run"
    assert m._factors[1] is uniq_before, "cache was rebuilt, not updated"

    linv_fresh, uniq_fresh = _fresh_factors(m)
    np.testing.assert_array_equal(np.asarray(m._factors[1]),
                                  np.asarray(uniq_fresh))
    np.testing.assert_allclose(np.asarray(m._factors[0]),
                               np.asarray(linv_fresh), rtol=1e-5,
                               atol=1e-5)

    # and test() results through the incremental cache match a fresh map
    r_cached = m.test(q)
    m._factors = None
    m._factors_slots = None
    r_fresh = m.test(q)
    np.testing.assert_allclose(r_cached, r_fresh, rtol=1e-5, atol=1e-5)


def test_factor_cache_invalidated_on_slot_set_change():
    from gpismap.api import GPisMap2D

    m = GPisMap2D()
    frames = frames_2d(2)
    m.update(*frames[0])
    m.test(np.zeros((4, 2), np.float32))
    assert m._factors is not None
    # a different pose inserts nodes into new cells -> slot set changes ->
    # the stale cache must be dropped (refilled lazily on next test)
    m.update(*frames[1])
    live = m._live_slots()
    if m._factors is not None:
        # cache survived: slot set must genuinely be unchanged
        np.testing.assert_array_equal(m._factors_slots, live)
    else:
        assert m._factors_slots is None


def test_bucketed_factorize_matches_full():
    """Factorizing at the retrain's support bucket and embedding into
    the full-M' layout must equal the full-size factorization (masked
    identity-row padding; cluster._factorize_cells_bucketed)."""
    import dataclasses

    from gpismap.config import CAPACITY_2D
    from gpismap.models import cluster

    rng = np.random.default_rng(7)
    cap = dataclasses.replace(CAPACITY_2D, gp_support=64, max_cells=8)
    d, b, mb, nvalid, scale = 3, 4, 32, 20, 0.8
    assert cluster.refresh_bucket(nvalid, 64, d) == mb
    store = cluster.make_store(cap, d)
    x = rng.normal(size=(b, mb, d)).astype(np.float32)
    g = rng.normal(size=(b, mb, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    valid = np.zeros((b, mb), bool)
    valid[:, :nvalid] = True
    store = cluster.retrain_cells(
        store, jnp.arange(b, dtype=jnp.int32), jnp.ones(b, bool),
        jnp.asarray(x), jnp.asarray(g),
        jnp.asarray(rng.normal(size=(b, mb)).astype(np.float32) * 0.1),
        jnp.full((b, mb), 0.02, jnp.float32),
        jnp.full((b, mb), 0.02, jnp.float32), jnp.asarray(valid), scale)

    slots = jnp.asarray([0, 1, 2, 3], jnp.int32)
    full = cluster._factorize_cells(store, slots, scale)
    buck = cluster._factorize_cells_bucketed(store, slots, scale, mb)
    np.testing.assert_allclose(np.asarray(full), np.asarray(buck),
                               rtol=0, atol=2e-5)

    # and through update_factors: refreshing with mb == refreshing full
    uniq = jnp.concatenate([slots, jnp.full(
        (cap.test_active_cells - b,), np.iinfo(np.int32).max, jnp.int32)])
    linv0 = jnp.zeros((cap.test_active_cells,) + full.shape[1:],
                      jnp.float32)
    # update_factors DONATES the buffer — pass a fresh copy per call
    up_full = cluster.update_factors(store, jnp.array(linv0), uniq, slots,
                                     scale)
    up_mb = cluster.update_factors(store, jnp.array(linv0), uniq, slots,
                                   scale, mb=mb)
    np.testing.assert_allclose(np.asarray(up_full), np.asarray(up_mb),
                               rtol=0, atol=2e-5)


def test_update_factors_from_l_matches_rebuild():
    """Refreshing the factor cache from the retrain fit's own Cholesky
    factor (cluster.update_factors_from_l — the reference's keep-L
    architecture) must equal the from-scratch rebuild."""
    import dataclasses

    from gpismap.config import CAPACITY_2D
    from gpismap.models import cluster

    rng = np.random.default_rng(11)
    cap = dataclasses.replace(CAPACITY_2D, gp_support=64, max_cells=8)
    d, b, mb, nvalid, scale = 3, 4, 32, 20, 0.8
    store = cluster.make_store(cap, d)
    x = rng.normal(size=(b, mb, d)).astype(np.float32)
    g = rng.normal(size=(b, mb, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    valid = np.zeros((b, mb), bool)
    valid[:, :nvalid] = True
    store, l = cluster._retrain_impl(
        store, jnp.arange(b, dtype=jnp.int32), jnp.ones(b, bool),
        jnp.asarray(x), jnp.asarray(g),
        jnp.asarray(rng.normal(size=(b, mb)).astype(np.float32) * 0.1),
        jnp.full((b, mb), 0.02, jnp.float32),
        jnp.full((b, mb), 0.02, jnp.float32), jnp.asarray(valid), scale)

    slots = jnp.asarray([0, 1, 2, 3], jnp.int32)
    uniq = jnp.concatenate([slots, jnp.full(
        (cap.test_active_cells - b,), np.iinfo(np.int32).max, jnp.int32)])
    mp = store.alpha.shape[-1]
    linv0 = jnp.zeros((cap.test_active_cells, mp, mp), jnp.float32)
    # both refresh functions DONATE the buffer — fresh copies per call
    up_full = cluster.update_factors(store, jnp.array(linv0), uniq, slots,
                                     scale)
    up_l = cluster.update_factors_from_l(jnp.array(linv0), uniq, slots, l,
                                         d=d)
    np.testing.assert_allclose(np.asarray(up_full), np.asarray(up_l),
                               rtol=0, atol=2e-5)
    # rows whose slot misses uniq are dropped, not scattered
    up_miss = cluster.update_factors_from_l(
        jnp.array(linv0), uniq, jnp.asarray([0, 7, -1, 3], jnp.int32), l,
        d=d)
    np.testing.assert_array_equal(np.asarray(up_miss[1]),
                                  np.zeros((mp, mp), np.float32))


def test_update_batch_matches_per_frame():
    """The pipelined update_batch is semantically the per-frame update()
    loop: identical node sets and query fields after the same frames."""
    from gpismap import datasets
    from gpismap.api import GPisMap2D

    frames = frames_2d(4)

    m1 = GPisMap2D()
    for th, rg, pose in frames:
        m1.update(th, rg, pose)
    mb = GPisMap2D()
    mb.update_batch(frames)

    assert m1.num_nodes == mb.num_nodes
    p1 = m1.get_all_points()
    pb = mb.get_all_points()
    np.testing.assert_allclose(np.sort(p1, axis=0), np.sort(pb, axis=0),
                               rtol=1e-6, atol=1e-6)

    q, _ = datasets.gazebo_test_grid()
    r1 = m1.test(q[::64])
    rb = mb.test(q[::64])
    np.testing.assert_allclose(r1, rb, rtol=1e-5, atol=1e-5)


def test_update_batch_3d_matches_per_frame():
    """3D pipelined update_batch == per-frame update() (fused reeval):
    same node set and query fields."""
    from gpismap import datasets
    from gpismap.api3d import GPisMap3D

    raw = frames_3d(2)
    m1 = GPisMap3D(cap=CAP_3D_SMALL)
    for depth, pose, cam in raw:
        m1.set_camera(cam)
        m1.update(depth, pose)
    mb = GPisMap3D(cap=CAP_3D_SMALL)
    mb.update_batch(raw)

    assert m1.num_nodes == mb.num_nodes
    np.testing.assert_allclose(
        np.sort(m1.get_all_points(), axis=0),
        np.sort(mb.get_all_points(), axis=0), rtol=1e-6, atol=1e-6)

    xt, _ = datasets.bigbird_test_grid()
    r1 = m1.test(xt[::64])
    rb = mb.test(xt[::64])
    np.testing.assert_allclose(r1, rb, rtol=1e-5, atol=1e-5)
