"""Checkpoint save/restore roundtrip."""
import os

import numpy as np

from gpismap.api import GPisMap2D
from gpismap.config import CapacityParam
from gpismap.runtime import checkpoint


def _small_mapper():
    cap = CapacityParam(gp_support=32, retrain_batch=16, max_cells=128,
                        max_nodes=2048, test_tile=32, test_active_cells=32,
                        max_beams=128)
    return GPisMap2D(cap=cap)


def _scan(phi=0.0):
    nb = 90
    th = np.linspace(-2.0, 2.0, nb).astype(np.float32)
    r = np.full(nb, 3.0, np.float32) / np.maximum(np.cos(th * 0.5), 0.4)
    pose = np.array([0, 0, np.cos(phi), np.sin(phi), -np.sin(phi),
                     np.cos(phi)], np.float32)
    return th, r, pose


def test_checkpoint_roundtrip(tmp_path):
    m = _small_mapper()
    th, r, pose = _scan()
    m.update(th, r, pose)
    th, r, pose = _scan(0.3)
    m.update(th, r, pose)
    q = np.asarray(np.random.default_rng(0).uniform(-4, 4, (64, 2)),
                   np.float32)
    before = m.test(q)
    n_before = m.num_nodes

    path = os.path.join(tmp_path, "map.npz")
    checkpoint.save(m, path)

    m2 = _small_mapper()
    checkpoint.load(m2, path)
    assert m2.num_nodes == n_before
    after = m2.test(q)
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)

    # restored mapper keeps working: another update + test
    th, r, pose = _scan(0.6)
    m2.update(th, r, pose)
    m.update(th, r, pose)
    assert m2.num_nodes == m.num_nodes
    np.testing.assert_allclose(m2.test(q), m.test(q), rtol=1e-4, atol=1e-5)


def test_mex_compat_surface():
    from gpismap import mex_compat

    mex_compat.gpismap("reset")
    th, r, pose = _scan()
    dt = mex_compat.gpismap("update", th, r, pose)
    assert dt >= 0
    res, dt = mex_compat.gpismap("test", np.zeros((2, 5), np.float32))
    assert res.shape == (6, 5)
    mex_compat.gpismap("reset")
