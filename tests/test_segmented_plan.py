"""plan_tiles gather formulation == the round-4 scatter reference,
exactly (same pair placement, same padding, same tile segments)."""
import numpy as np
import jax.numpy as jnp

from gpismap.ops import segmented


def _check(seg, n_segments, tile):
    a = segmented.plan_tiles(jnp.asarray(seg, jnp.int32), n_segments, tile)
    b = segmented._plan_tiles_scatter_ref(jnp.asarray(seg, jnp.int32),
                                          n_segments, tile)
    np.testing.assert_array_equal(np.asarray(a.pair_ids),
                                  np.asarray(b.pair_ids))
    np.testing.assert_array_equal(np.asarray(a.tile_seg),
                                  np.asarray(b.tile_seg))
    assert int(a.n_tiles) == int(b.n_tiles)
    # invariants: every valid pair appears exactly once, in its segment
    pid = np.asarray(a.pair_ids)
    ts = np.asarray(a.tile_seg)
    flat = pid[pid >= 0]
    valid_ids = np.nonzero(np.asarray(seg) >= 0)[0]
    np.testing.assert_array_equal(np.sort(flat), np.sort(valid_ids))
    for t in range(pid.shape[0]):
        ids = pid[t][pid[t] >= 0]
        if len(ids):
            assert ts[t] >= 0
            assert (np.asarray(seg)[ids] == ts[t]).all()


def test_plan_tiles_matches_scatter_reference():
    rng = np.random.default_rng(0)
    for trial in range(8):
        p = int(rng.integers(1, 700))
        ns = int(rng.integers(1, 20))
        tile = int(rng.choice([4, 16, 128]))
        seg = rng.integers(-1, ns, p)
        _check(seg, ns, tile)
    # edge cases: all invalid, one segment, exact tile multiples
    _check(np.full(64, -1), 8, 16)
    _check(np.zeros(64, np.int32), 8, 16)
    _check(np.repeat(np.arange(4), 16), 8, 16)


def test_plan_tiles_bench_shape_smoke():
    """The packed-key path at a bench-like shape (P=3*65536, S=512)."""
    rng = np.random.default_rng(1)
    seg = rng.integers(-1, 400, 3 * 4096)
    _check(seg, 512, 128)


def _check_for_slots(slots_raw, uniq, max_cells, max_active, tile):
    """plan_tiles_for_slots == dense-LUT compact + plan_tiles, exactly
    (including dropped out-of-uniq and out-of-range slots)."""
    lut = np.full(max_cells + 1, -1, np.int32)
    big = np.iinfo(np.int32).max
    for i, u in enumerate(uniq):
        if u < big:
            lut[u] = i
    in_range = (slots_raw >= 0) & (slots_raw < max_cells)
    comp = np.where(in_range, lut[np.clip(slots_raw, 0, max_cells - 1)],
                    -1)
    ref = segmented.plan_tiles(jnp.asarray(comp, jnp.int32), max_active,
                               tile)
    got, n_in = segmented.plan_tiles_for_slots(
        jnp.asarray(slots_raw, jnp.int32), jnp.asarray(uniq, jnp.int32),
        max_cells, max_active, tile)
    np.testing.assert_array_equal(np.asarray(got.pair_ids),
                                  np.asarray(ref.pair_ids))
    np.testing.assert_array_equal(np.asarray(got.tile_seg),
                                  np.asarray(ref.tile_seg))
    assert int(got.n_tiles) == int(ref.n_tiles)
    assert int(n_in) == int((comp >= 0).sum())


def test_plan_tiles_for_slots_matches_lut_compact():
    rng = np.random.default_rng(7)
    big = np.iinfo(np.int32).max
    for trial in range(6):
        max_cells = int(rng.choice([64, 256]))
        max_active = 16
        tile = int(rng.choice([4, 16]))
        p = int(rng.integers(1, 600))
        # active slot set: sorted unique subset, big-padded
        n_act = int(rng.integers(1, max_active + 1))
        act = np.sort(rng.choice(max_cells, n_act, replace=False))
        uniq = np.full(max_active, big, np.int64)
        uniq[:n_act] = act
        # raw slots: mix of active, inactive-but-valid, -1, out-of-range
        pool = np.concatenate([act, rng.integers(0, max_cells, 8),
                               [-1, -1, max_cells + 3]])
        slots_raw = rng.choice(pool, p)
        _check_for_slots(slots_raw, uniq, max_cells, max_active, tile)


def test_plan_tiles_for_slots_bench_shape():
    rng = np.random.default_rng(8)
    big = np.iinfo(np.int32).max
    max_cells, max_active, tile = 4096, 512, 128
    act = np.sort(rng.choice(max_cells, 300, replace=False))
    uniq = np.full(max_active, big, np.int64)
    uniq[:300] = act
    slots_raw = np.where(rng.random(3 * 4096) < 0.3, -1,
                         rng.choice(act, 3 * 4096))
    _check_for_slots(slots_raw, uniq, max_cells, max_active, tile)


def test_plan_tiles_for_slots_unpacked_fallback():
    """Huge slot-id space forces the argsort+bincount fallback."""
    rng = np.random.default_rng(9)
    big = np.iinfo(np.int32).max
    max_cells, max_active, tile = 40_000, 16, 16   # 40001 * P2 > 2^31
    act = np.sort(rng.choice(max_cells, 9, replace=False))
    uniq = np.full(max_active, big, np.int64)
    uniq[:9] = act
    pool = np.concatenate([act, [-1, 17, max_cells + 5]])
    slots_raw = rng.choice(pool, 33_000)           # P2 = 65536
    _check_for_slots(slots_raw, uniq, max_cells, max_active, tile)


def test_plan_tiles_unpacked_fallback():
    """(S+1)*P2 >= 2^31 forces the argsort+bincount fallback (the
    packed int32 key would overflow); it must produce the same plan."""
    rng = np.random.default_rng(2)
    ns = 40_000                       # 40001 * 65536 > 2^31
    p = 33_000                        # P2 = 65536
    seg = rng.integers(-1, 200, p)    # few live segments, huge id space
    a = segmented.plan_tiles(jnp.asarray(seg, jnp.int32), ns, 128)
    b = segmented._plan_tiles_scatter_ref(jnp.asarray(seg, jnp.int32),
                                          ns, 128)
    np.testing.assert_array_equal(np.asarray(a.pair_ids),
                                  np.asarray(b.pair_ids))
    np.testing.assert_array_equal(np.asarray(a.tile_seg),
                                  np.asarray(b.tile_seg))
    assert int(a.n_tiles) == int(b.n_tiles)
