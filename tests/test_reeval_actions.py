"""Action-1 (noise doubling) re-evaluation parity.

Reference: a re-evaluated node whose finite-difference occupancy gradient
degenerates (norm_g < 1e-3) gets its noises DOUBLED in place
(GPisMap.cpp:354-357 -> updateNoise(2*psig, 2*gsig); GPisMap3.cpp:462-466).
Round-4 verdict found the packed per-frame pull destroyed this outcome by
coercing the doubled noises to booleans in unpack_frame_results; these
tests force action-1 traffic through every default path and pin the exact
2x semantics.

The synthetic scenario that forces norm_g < 1e-3: observe a wall at close
range (creates HIT nodes), then observe a much FARTHER wall from the same
pose. The old nodes sit deep on the occupied side, the logistic occupancy
proxy saturates at +1 for the node and all its probes (slope a = r*30), so
the finite-difference gradient is ~0 and every re-evaluated node must take
action 1.
"""
import numpy as np
import pytest


# ---------------------------------------------------------------------------
# unit: pack -> unpack round trip preserves the doubled noises as floats
# ---------------------------------------------------------------------------

def test_pack_unpack_preserves_doubled_noises_2d():
    import jax.numpy as jnp
    from gpismap.models import mapper2d

    k, nb = 4, 2
    rv = mapper2d.Reeval2D(
        action=jnp.array([1, 0, 1, 3], jnp.int32),
        pos=jnp.arange(k * 2, dtype=jnp.float32).reshape(k, 2),
        grad=jnp.ones((k, 2), jnp.float32),
        noise=jnp.full((k,), 0.25, jnp.float32),
        grad_noise=jnp.full((k,), 0.5, jnp.float32),
        dbl_pos_sig=jnp.array([0.16, 0.08, 1.5, 0.02], jnp.float32),
        dbl_grad_sig=jnp.array([3.0, 0.4, 0.02, 2.0], jnp.float32))
    nm = mapper2d.NewMeas2D(
        insert_ok=jnp.array([True, False]),
        pos=jnp.zeros((nb, 2), jnp.float32),
        grad=jnp.zeros((nb, 2), jnp.float32),
        noise=jnp.zeros((nb,), jnp.float32),
        grad_noise=jnp.zeros((nb,), jnp.float32))
    flat = np.asarray(mapper2d.pack_frame_results(rv, nm))
    rv2, nm2 = mapper2d.unpack_frame_results(flat, k, nb)
    # the verdict's repro: [0.16, 3.0] must come back as [0.16, 3.0]
    np.testing.assert_array_equal(np.asarray(rv2.dbl_pos_sig),
                                  np.asarray(rv.dbl_pos_sig))
    np.testing.assert_array_equal(np.asarray(rv2.dbl_grad_sig),
                                  np.asarray(rv.dbl_grad_sig))
    np.testing.assert_array_equal(np.asarray(rv2.action),
                                  np.asarray(rv.action))
    np.testing.assert_array_equal(np.asarray(nm2.insert_ok),
                                  np.asarray(nm.insert_ok))


def test_pack_unpack_preserves_doubled_noises_3d():
    import jax.numpy as jnp
    from gpismap.models import mapper3d

    k, p = 3, 2
    rv = mapper3d.Reeval3D(
        action=jnp.array([1, 1, 0], jnp.int32),
        pos=jnp.zeros((k, 3), jnp.float32),
        grad=jnp.zeros((k, 3), jnp.float32),
        noise=jnp.zeros((k,), jnp.float32),
        grad_noise=jnp.zeros((k,), jnp.float32),
        dbl_pos_sig=jnp.array([0.16, 0.002, 0.7], jnp.float32),
        dbl_grad_sig=jnp.array([3.0, 0.04, 0.3], jnp.float32))
    nm = mapper3d.NewMeas3D(
        insert_ok=jnp.array([False, True]),
        pos=jnp.zeros((p, 3), jnp.float32),
        grad=jnp.zeros((p, 3), jnp.float32),
        noise=jnp.zeros((p,), jnp.float32),
        grad_noise=jnp.zeros((p,), jnp.float32))
    flat = np.asarray(mapper3d.pack_frame_results(rv, 5, nm))
    rv2, drop, nm2 = mapper3d.unpack_frame_results(flat, k, p)
    np.testing.assert_array_equal(np.asarray(rv2.dbl_pos_sig),
                                  np.asarray(rv.dbl_pos_sig))
    np.testing.assert_array_equal(np.asarray(rv2.dbl_grad_sig),
                                  np.asarray(rv.dbl_grad_sig))
    assert drop == 5
    np.testing.assert_array_equal(np.asarray(nm2.insert_ok),
                                  np.asarray(nm.insert_ok))


# ---------------------------------------------------------------------------
# integration: action-1 traffic through the real update paths
# ---------------------------------------------------------------------------

def _scan_2d(r):
    # keep r off the tree's cell-boundary lattice (multiples of
    # min_halfleng): boundary points fall in NO cell under the
    # reference's strict-inequality AABB containsPoint (quadtree.h:93-98,
    # replicated by the native index) and would be rejected at insert
    th = np.linspace(-0.6, 0.6, 181).astype(np.float32)
    rg = np.full_like(th, r)
    pose = np.array([0, 0, 1, 0, 0, 1], np.float32)  # identity, col-major
    return th, rg, pose


def _all_node_ids(index):
    cells = index.all_cluster_cells()
    lists = [index.cell_nodes(c) for c in cells]
    return (np.unique(np.concatenate(lists)).astype(np.int32)
            if lists else np.zeros(0, np.int32))


def _check_doubling(index, ids, ps0, gs0, min_frac=0.5):
    d = index.get_nodes(ids)
    assert d["alive"].all(), "action-1 scenario must not remove nodes"
    ps1, gs1 = d["pos_sig"], d["grad_sig"]
    doubled = np.isclose(ps1, 2.0 * ps0, rtol=1e-6) & np.isclose(
        gs1, 2.0 * gs0, rtol=1e-6)
    unchanged = (ps1 == ps0) & (gs1 == gs0)
    # every node either re-evaluated (exactly doubled) or failed the
    # obs-variance gate (untouched); nothing else is legal here
    assert np.all(doubled | unchanged), (
        ps0[~(doubled | unchanged)], ps1[~(doubled | unchanged)])
    frac = doubled.mean()
    assert frac >= min_frac, f"only {frac:.2f} of nodes took action 1"


@pytest.mark.parametrize("mode", ["packed", "batch", "strict"])
def test_action1_doubles_node_noises_2d(mode):
    """A far-wall rescan saturates the occupancy proxy -> norm_g < 1e-3 ->
    every in-view node's noises must be EXACTLY doubled
    (GPisMap.cpp:354-357), through the packed default update(), the
    pipelined update_batch(), and the strict replay path alike."""
    from gpismap.api import GPisMap2D

    m = GPisMap2D(strict_reeval=(mode == "strict"))
    th1, rg1, pose = _scan_2d(2.03)
    m.update(th1, rg1, pose)
    ids = _all_node_ids(m.index)
    assert len(ids) > 0
    before = m.index.get_nodes(ids)
    ps0, gs0 = before["pos_sig"].copy(), before["grad_sig"].copy()
    assert np.all(ps0 > 0) and np.all(ps0 < 0.5), ps0  # doubling visible

    th2, rg2, _ = _scan_2d(8.07)
    if mode == "batch":
        m.update_batch([(th2, rg2, pose)])
    else:
        m.update(th2, rg2, pose)
    _check_doubling(m.index, ids, ps0, gs0)


@pytest.mark.parametrize("mode", ["hybrid", "fused", "strict"])
def test_action1_doubles_node_noises_3d(mode):
    """3D twin (GPisMap3.cpp:462-466): close wall then far wall through
    the hybrid (default, packed), fused-scan, and strict replay paths."""
    from gpismap.api3d import GPisMap3D
    from gpismap.config import CameraParam

    # fine enough ray spacing that the ObsGP posterior variance at the
    # relocated probe positions stays under obs_var_thre=0.04 (tangent
    # spacing 2/fx = 0.017; at 0.067 the probes measured var ~0.05)
    cam = CameraParam(fx=120.0, fy=120.0, cx=32.0, cy=24.0,
                      width=64, height=48)
    m = GPisMap3D(reeval_mode=mode)
    m.set_camera(cam)
    pose = np.concatenate([np.zeros(3), np.eye(3).ravel(order="F")]
                          ).astype(np.float32)
    m.update(np.full((48, 64), 0.53, np.float32), pose)
    ids = _all_node_ids(m.index)
    assert len(ids) > 0
    before = m.index.get_nodes(ids)
    ps0, gs0 = before["pos_sig"].copy(), before["grad_sig"].copy()
    assert np.all(ps0 > 0) and np.all(ps0 < 0.5), ps0

    m.update(np.full((48, 64), 2.11, np.float32), pose)
    _check_doubling(m.index, ids, ps0, gs0)


def test_action1_doubles_node_noises_3d_batch():
    """update_batch() (the pipelined packed pull) applies the same 2x."""
    from gpismap.api3d import GPisMap3D
    from gpismap.config import CameraParam

    # fine enough ray spacing that the ObsGP posterior variance at the
    # relocated probe positions stays under obs_var_thre=0.04 (tangent
    # spacing 2/fx = 0.017; at 0.067 the probes measured var ~0.05)
    cam = CameraParam(fx=120.0, fy=120.0, cx=32.0, cy=24.0,
                      width=64, height=48)
    m = GPisMap3D()
    m.set_camera(cam)
    pose = np.concatenate([np.zeros(3), np.eye(3).ravel(order="F")]
                          ).astype(np.float32)
    m.update(np.full((48, 64), 0.53, np.float32), pose)
    ids = _all_node_ids(m.index)
    before = m.index.get_nodes(ids)
    ps0, gs0 = before["pos_sig"].copy(), before["grad_sig"].copy()

    m.update_batch([(np.full((48, 64), 2.11, np.float32), pose)])
    _check_doubling(m.index, ids, ps0, gs0)
