"""Candidate-table (NeighborTable) equivalence with the window path.

The table is a pure layout change — row gathers instead of per-query
window gathers — so results must be EXACTLY equal (same candidate set,
same order for tie-breaks, same floats).
"""
import numpy as np
import jax.numpy as jnp

from test_parallel import _circle_map
from workloads import CAP_3D_SMALL, frames_2d, frames_3d


def _live_cells(idx, cell_size=1.6):
    cells = idx.all_cluster_cells()
    centers, _, slots = idx.cell_info(cells)
    live = slots >= 0
    coords = np.floor(centers / cell_size).astype(np.int32)
    n = int(live.sum())
    cpad = max(64, 1 << (n - 1).bit_length())
    cc = np.zeros((cpad, 2), np.int32)
    sl = np.full(cpad, -1, np.int32)
    cc[:n] = coords[live]
    sl[:n] = slots[live]
    return cc, sl


def test_neighbor_table_matches_window():
    from gpismap.config import TREE_2D
    from gpismap.models import cluster
    from gpismap.runtime import SpatialIndex

    store, grid, kw = _circle_map()
    # rebuild the same index to get the live cell list
    idx = SpatialIndex(2, TREE_2D, max_slots=64)
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ids = idx.try_insert(pts)
    ok = ids >= 0
    normals = pts[ok] / np.linalg.norm(pts[ok], axis=1, keepdims=True)
    idx.set_node_data(ids[ok], np.full(ok.sum(), -0.2, np.float32),
                      np.full(ok.sum(), 0.02, np.float32), normals,
                      np.full(ok.sum(), 0.02, np.float32))
    cc, sl = _live_cells(idx)

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.uniform(-3, 3, (256, 2)), jnp.float32)
    ref = cluster.map_test(store, grid, q, **kw)

    for dense in (True, False):
        nbrs = cluster.build_neighbor_table(
            jnp.asarray(cc), jnp.asarray(sl), store.trained,
            grid_half=kw["grid_half"], noff=kw["noff"], k_cap=16,
            dense=dense)
        assert int(nbrs.n_overflow) == 0
        out = cluster.map_test(store, grid, q, nbrs=nbrs,
                               nbr_dense=dense, **kw)
        for a, b, name in zip(ref, out, ("f", "g", "vf", "vg", "nd")):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"dense={dense} {name}")


def test_two_phase_matches_single_phase():
    """The two-phase schedule (ranks 1-2 evaluated only for uncertain
    queries, GPisMap.cpp:706-722) must return EXACTLY the single-phase
    fields — the selection never reads rank-1/2 results of confident
    queries, so skipping them is a pure work reduction."""
    from gpismap.models import cluster

    store, grid, kw = _circle_map()
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.uniform(-3, 3, (512, 2)), jnp.float32)
    f1, g1, v1, w1, i1 = cluster.map_test(store, grid, q,
                                          two_phase=False, **kw)
    f2, g2, v2, w2, i2 = cluster.map_test(store, grid, q,
                                          two_phase=True, **kw)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    # the work counters prove both that phase 2 ran and that pairs were
    # actually skipped
    assert int(i2.n_phase2) > 0
    assert int(i2.n_pairs) < int(i1.n_pairs)
    assert int(i1.n_dropped) == int(i2.n_dropped) == 0


def test_flat_eval_matches_scan():
    """The flat (non-scanned) tile evaluation used by the differentiable
    render correction must equal the chunked-scan evaluation."""
    from gpismap.models import cluster

    store, grid, kw = _circle_map()
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.uniform(-3, 3, (256, 2)), jnp.float32)
    a = cluster.map_test(store, grid, q, two_phase=False, **kw)
    b = cluster.map_test(store, grid, q, two_phase=False, flat_eval=True,
                         **kw)
    for x, y, name in zip(a[:4], b[:4], ("f", "g", "vf", "vg")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def test_neighbor_table_overflow_counted():
    from gpismap.config import TREE_2D
    from gpismap.models import cluster
    from gpismap.runtime import SpatialIndex

    store, grid, kw = _circle_map()
    idx = SpatialIndex(2, TREE_2D, max_slots=64)
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ids = idx.try_insert(pts)
    ok = ids >= 0
    idx.set_node_data(ids[ok], np.full(ok.sum(), -0.2, np.float32),
                      np.full(ok.sum(), 0.02, np.float32),
                      pts[ok] / np.linalg.norm(pts[ok], 2, 1,
                                               keepdims=True),
                      np.full(ok.sum(), 0.02, np.float32))
    cc, sl = _live_cells(idx)
    # k_cap 1 cannot hold the full windows -> overflow must be counted
    nbrs = cluster.build_neighbor_table(
        jnp.asarray(cc), jnp.asarray(sl), store.trained,
        grid_half=kw["grid_half"], noff=kw["noff"], k_cap=1, dense=True)
    assert int(nbrs.n_overflow) > 0


def test_mapper_surfaces_nbr_overflow(monkeypatch):
    """A too-small nbr_k must surface in stats["nbr_overflow"] through
    the full API path (never a silent divergence from the window path)."""
    import dataclasses

    from gpismap import datasets
    from gpismap.api import GPisMap2D
    from gpismap.config import CAPACITY_2D

    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    m = GPisMap2D(cap=dataclasses.replace(CAPACITY_2D, nbr_k=1))
    for fr in frames_2d(2):
        m.update(*fr)
    q, _ = datasets.gazebo_test_grid()
    m.test(q[::64])
    assert m.stats.get("nbr_overflow", 0) > 0


def test_mapper_table_matches_window_2d(monkeypatch):
    """GPisMap2D with the table forced on == table off, over real
    frames (insert/retrain churn rebuilds the table each frame)."""
    from gpismap import datasets
    from gpismap.api import GPisMap2D

    frames = frames_2d(3)
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "0")
    m0 = GPisMap2D()
    for fr in frames:
        m0.update(*fr)
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    m1 = GPisMap2D()
    for fr in frames:
        m1.update(*fr)

    q, _ = datasets.gazebo_test_grid()
    r0 = m0.test(q[::32])
    r1 = m1.test(q[::32])
    assert m1._nbrs is not None          # built lazily by test()
    np.testing.assert_array_equal(r0, r1)


def test_build_grid_device_matches_host():
    from gpismap.models import cluster

    rng = np.random.default_rng(1)
    for dim, gh in ((2, 16), (3, 8)):
        n = 40
        coords = rng.integers(-gh, gh, (n, dim)).astype(np.int64)
        coords = np.unique(coords, axis=0)
        slots = np.arange(len(coords), dtype=np.int32)
        host = np.asarray(cluster.build_grid(coords, slots, dim, gh))
        cpad = 64
        cc = np.zeros((cpad, dim), np.int32)
        sl = np.full(cpad, -1, np.int32)
        cc[:len(coords)] = coords
        sl[:len(coords)] = slots
        dev = np.asarray(cluster.build_grid_device(
            jnp.asarray(cc), jnp.asarray(sl), dim, gh))
        np.testing.assert_array_equal(host, dev, err_msg=f"dim={dim}")


def test_mapper_mirror_matches_host_gather(monkeypatch):
    """Retrain through the device node mirror == host-gathered support
    (identical store state and query fields over real frames with
    insert/reeval churn)."""
    from gpismap import datasets
    from gpismap.api import GPisMap2D

    frames = frames_2d(3)
    monkeypatch.setenv("GPISMAP_NODE_MIRROR", "0")
    m0 = GPisMap2D()
    for fr in frames:
        m0.update(*fr)
    assert m0._mirror is None
    monkeypatch.setenv("GPISMAP_NODE_MIRROR", "1")
    m1 = GPisMap2D()
    for fr in frames:
        m1.update(*fr)
    assert m1._mirror is not None

    np.testing.assert_array_equal(np.asarray(m0.store.alpha),
                                  np.asarray(m1.store.alpha))
    np.testing.assert_array_equal(np.asarray(m0.store.valid),
                                  np.asarray(m1.store.valid))
    q, _ = datasets.gazebo_test_grid()
    np.testing.assert_array_equal(m0.test(q[::32]), m1.test(q[::32]))


def test_mapper_mirror_3d_two_frames(monkeypatch):
    """3D twin (exercises the hybrid-reeval dirty tracking incl.
    re-inserted mover ids)."""
    from gpismap import datasets
    from gpismap.api3d import GPisMap3D

    raw = frames_3d(2)
    monkeypatch.setenv("GPISMAP_NODE_MIRROR", "0")
    m0 = GPisMap3D(cap=CAP_3D_SMALL)
    for depth, pose, cam in raw:
        m0.set_camera(cam)
        m0.update(depth, pose)
    monkeypatch.setenv("GPISMAP_NODE_MIRROR", "1")
    m1 = GPisMap3D(cap=CAP_3D_SMALL)
    for depth, pose, cam in raw:
        m1.set_camera(cam)
        m1.update(depth, pose)
    np.testing.assert_array_equal(np.asarray(m0.store.alpha),
                                  np.asarray(m1.store.alpha))
    xt, _ = datasets.bigbird_test_grid()
    np.testing.assert_array_equal(m0.test(xt[::64]), m1.test(xt[::64]))


def test_fused_epilogue_folds_table_and_factors(monkeypatch):
    """The one-dispatch epilogue (cluster.frame_finish_full) must leave
    the mapper holding a candidate table equal to a fresh
    build_neighbor_table AND a factor cache equal to a fresh
    factorize_slots — the two upkeep stages it folded in (round-4
    BASELINE headroom #1)."""
    import jax.numpy as jnp

    from gpismap.api import GPisMap2D
    from gpismap.models import cluster

    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    m = GPisMap2D()
    # one retrain bucket -> one group -> the fused epilogue runs whatever
    # the fit-dispatch default (_retrain_store)
    m._retrain_buckets = (m.cap.gp_support,)
    fr = frames_2d(1)[0]
    m.update(*fr)
    m.test(np.zeros((8, 2), np.float32))     # fill table + factor cache
    assert m._nbrs is not None and m._factors is not None
    # same scan again: slot set unchanged -> fused epilogue folds both
    m.update(*fr)
    assert m._nbrs is not None, "folded table missing"
    assert m._factors is not None, "folded factor refresh missing"

    nbrs_folded = m._nbrs
    m._nbrs = None
    m._build_nbrs()
    for a, b in zip(nbrs_folded, m._nbrs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    live = m._live_slots()
    pad = np.full(m.cap.test_active_cells, -1, np.int32)
    pad[:len(live)] = live
    linv_fresh, uniq_fresh = cluster.factorize_slots(
        m.store, jnp.asarray(pad), m.p.map_scale_param,
        m.cap.test_active_cells)
    np.testing.assert_array_equal(np.asarray(m._factors[1]),
                                  np.asarray(uniq_fresh))
    np.testing.assert_allclose(np.asarray(m._factors[0]),
                               np.asarray(linv_fresh), rtol=1e-5,
                               atol=1e-5)


def test_candidates_top3_fused_matches_two_stage():
    """_candidates_top3 (transposed fused path) must reproduce the
    two-stage _table_candidates + 3-pass-argmin selection exactly,
    including argmin's first-lowest-index tie order (synthetic table
    with many duplicate distances)."""
    import jax.numpy as jnp

    from gpismap.models import cluster

    rng = np.random.default_rng(3)
    t, k, d, nq = 64, 12, 2, 513
    grid_half = 8
    noff = 3
    w = (2 * noff + 1) ** d
    w2 = 1 << (w - 1).bit_length()
    keys = np.arange(t, dtype=np.int32)          # dense variant
    slot = rng.integers(-1, 30, (t, k)).astype(np.int32)
    rank = rng.integers(0, w, (t, k)).astype(np.int32)
    packed = np.where(slot >= 0, slot * w2 + rank, -1).astype(np.int32)
    nbrs = cluster.NeighborTable(
        keys=jnp.asarray(keys), packed=jnp.asarray(packed),
        n_overflow=jnp.int32(0))
    cell = 1.0
    q = np.round(rng.uniform(-7, 7, (nq, d))).astype(np.float32) + 0.5
    q = jnp.asarray(q)   # lattice-ish points force exact sqd ties

    slots, sqd, ok = cluster._table_candidates(nbrs, q, cell, grid_half,
                                               noff, 3.0, True)
    n_cand = jnp.sum(ok, -1)
    sqd_m = jnp.where(ok, sqd, jnp.inf)
    cols = jnp.arange(k, dtype=jnp.int32)
    cur = sqd_m
    tops = []
    for _ in range(3):
        i = jnp.argmin(cur, axis=-1).astype(jnp.int32)
        tops.append(i)
        cur = jnp.where(cols[None, :] == i[:, None], jnp.inf, cur)
    top_idx = jnp.stack(tops, -1)
    ref_slot = jnp.take_along_axis(slots, top_idx, axis=-1)
    ref_ok = (jnp.take_along_axis(ok, top_idx, axis=-1)
              & (jnp.arange(3)[None] < n_cand[:, None]))

    got_slot, got_ok, got_n = cluster._candidates_top3(
        nbrs, q, cell, grid_half, noff, 3.0, True)
    np.testing.assert_array_equal(np.asarray(got_n), np.asarray(n_cand))
    np.testing.assert_array_equal(np.asarray(got_ok), np.asarray(ref_ok))
    np.testing.assert_array_equal(np.asarray(got_slot)[np.asarray(ref_ok)],
                                  np.asarray(ref_slot)[np.asarray(ref_ok)])
