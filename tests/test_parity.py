"""End-to-end parity vs captured reference goldens (short sequences).

The goldens were captured from the UNMODIFIED reference C++ on the
reference's own recordings (gazebo1, bigbird "detergent"); these tests
run when $GPISMAP_DATA holds those recordings and skip otherwise.
"""
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _need(name):
    if not os.environ.get("GPISMAP_DATA"):
        pytest.skip("reference recordings not available ($GPISMAP_DATA)")
    p = os.path.join(GOLDEN_DIR, name)
    if not os.path.exists(p):
        pytest.skip(f"golden {name} not captured")
    return np.load(p)


@pytest.mark.slow
def test_parity_2d_two_frames():
    from gpismap import datasets
    from gpismap.api import GPisMap2D

    g = _need("golden_2d_f2.npz")
    xtest = g["xtest"][::64]
    ref = g["res"][::64]

    m = GPisMap2D()
    for fr in list(datasets.gazebo_frames())[:2]:
        m.update(fr.thetas, fr.ranges, fr.pose)
    res = m.test(xtest)

    mapped_ref = ref[:, 3] < 1.0
    mapped = res[:, 3] < 1.0
    agree = (mapped_ref == mapped).mean()
    assert agree > 0.99, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    assert both.sum() > 50
    df = np.abs(res[both, 0] - ref[both, 0])
    dg = np.abs(res[both, 1:3] - ref[both, 1:3])
    assert np.median(df) < 5e-3, np.median(df)
    assert np.percentile(df, 95) < 5e-2
    assert np.median(dg) < 5e-3


@pytest.mark.slow
def test_parity_2d_full_sequence():
    """All 28 demo frames (matlab/demo_gpisMap.m:37-40) vs the full-run
    golden; grid subsampled [::16] (~3.1k pts) to bound suite time. The
    reference workload itself is NOT shortened — a regression anywhere in
    the 28-frame online loop fails this gate."""
    from gpismap import datasets
    from gpismap.api import GPisMap2D

    g = _need("golden_2d.npz")
    assert len(g["frames"]) == 28
    xtest = g["xtest"][::16]
    ref = g["res"][::16]

    m = GPisMap2D()
    n_frames = 0
    for fr in datasets.gazebo_frames():
        m.update(fr.thetas, fr.ranges, fr.pose)
        n_frames += 1
    assert n_frames == 28
    res = m.test(xtest)

    mapped_ref = ref[:, 3] < 1.0
    mapped = res[:, 3] < 1.0
    agree = (mapped_ref == mapped).mean()
    assert agree > 0.995, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    assert both.sum() > 1000
    df = np.abs(res[both, 0] - ref[both, 0])
    dg = np.abs(res[both, 1:3] - ref[both, 1:3])
    dv = np.abs(res[both, 3] - ref[both, 3])
    assert np.median(df) < 2e-3, np.median(df)
    assert np.percentile(df, 95) < 2e-2, np.percentile(df, 95)
    assert np.median(dg) < 2e-3, np.median(dg)
    assert np.median(dv) < 2e-3, np.median(dv)


@pytest.mark.slow
def test_parity_3d_fused_reeval_four_frames():
    """The default 'fused' re-evaluation (one lax.scan dispatch per frame,
    mapper3d.reeval_scan_3d) must track the reference golden over frames
    with real per-cell re-evaluation traffic. Its only permitted deviation
    from the exact host replay is in-frame insertion dedup (see
    reeval_scan_3d docstring), so the node count may differ by a few."""
    from gpismap import datasets
    from gpismap.api3d import GPisMap3D

    g = _need("golden_3d_f4.npz")
    xtest = g["xtest"][::16]
    ref = g["res"][::16]

    m = GPisMap3D()
    assert m.reeval_mode == "hybrid"   # round-3 default (scan-equivalent)
    for fr in list(datasets.bigbird_frames())[:4]:
        m.set_camera(fr.cam_id, "bigbird")
        m.update(fr.depth, fr.pose)

    if "nodes" in g:
        nodes_ref = g["nodes"]
        ours = m.get_all_points()
        assert abs(len(ours) - len(nodes_ref)) <= max(
            3, len(nodes_ref) // 100)

    res = m.test(xtest)
    mapped_ref = ref[:, 4] < 1.0
    mapped = res[:, 4] < 1.0
    agree = (mapped_ref == mapped).mean()
    # the 4-frame mark is the noisiest point of the sequence: the strict
    # host replay itself measures 99.50 % here (PARITY.md); the full
    # 40-frame run converges to 99.99 %
    assert agree > 0.99, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    df = np.abs(res[both, 0] - ref[both, 0])
    dg = np.abs(res[both, 1:4] - ref[both, 1:4])
    assert np.median(df) < 5e-3, np.median(df)
    assert np.median(dg) < 0.1, np.median(dg)
    assert np.percentile(df, 95) < 5e-2


@pytest.mark.slow
def test_parity_3d_one_frame():
    from gpismap import datasets
    from gpismap.api3d import GPisMap3D

    g = _need("golden_3d_f1.npz")
    xtest = g["xtest"][::16]
    ref = g["res"][::16]

    m = GPisMap3D()
    fr = next(datasets.bigbird_frames())
    m.set_camera(fr.cam_id, "bigbird")
    m.update(fr.depth, fr.pose)

    # node-set parity is exact after one frame
    nodes_ref = g["nodes"]
    ours = m.get_all_points()
    assert len(ours) == len(nodes_ref)

    res = m.test(xtest)
    mapped_ref = ref[:, 4] < 1.0
    mapped = res[:, 4] < 1.0
    agree = (mapped_ref == mapped).mean()
    assert agree > 0.995, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    df = np.abs(res[both, 0] - ref[both, 0])
    dg = np.abs(res[both, 1:4] - ref[both, 1:4])
    assert np.median(df) < 2e-3, np.median(df)
    assert np.median(dg) < 2e-3, np.median(dg)
    assert np.percentile(df, 95) < 2e-2


@pytest.mark.slow
def test_reeval_hybrid_matches_scan():
    """reeval_hybrid_3d (vectorized pass + mover fix-up) must be
    observably equivalent to reeval_scan_3d (the strict per-cell lax.scan)
    over generated frames with re-evaluation + relocation traffic:
    identical node sets and matching query fields."""
    from gpismap.api3d import GPisMap3D
    from workloads import CAP_3D_SMALL, frames_3d

    ms = GPisMap3D(cap=CAP_3D_SMALL, reeval_mode="fused")
    mh = GPisMap3D(cap=CAP_3D_SMALL, reeval_mode="hybrid")
    for depth, pose, cam in frames_3d(4):
        for m in (ms, mh):
            m.set_camera(cam)
            m.update(depth, pose)
        assert ms.num_nodes == mh.num_nodes, f"frame {ms.frame - 1}"

    ps = np.sort(ms.get_all_points(), axis=0)
    ph = np.sort(mh.get_all_points(), axis=0)
    np.testing.assert_allclose(ps, ph, rtol=1e-5, atol=1e-5)

    from gpismap import datasets as ds
    xt, _ = ds.bigbird_test_grid()
    rs = ms.test(xt[::32])
    rh = mh.test(xt[::32])
    np.testing.assert_allclose(rs, rh, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_parity_3d_twelve_frames_sequence_gate():
    """Regression gate for the long-sequence 3D parity number. 12 frames
    of the demo schedule
    (matlab/demo_gpisMap3.m:41-47) against a reference golden captured
    at the same mark; fails if mapped agreement or median f error
    regress."""
    from gpismap import datasets
    from gpismap.api3d import GPisMap3D

    g = _need("golden_3d_f12.npz")
    xtest = g["xtest"][::8]
    ref = g["res"][::8]

    m = GPisMap3D()
    for fr in list(datasets.bigbird_frames())[:12]:
        m.set_camera(fr.cam_id, "bigbird")
        m.update(fr.depth, fr.pose)

    res = m.test(xtest)
    mapped_ref = ref[:, 4] < 1.0
    mapped = res[:, 4] < 1.0
    agree = (mapped_ref == mapped).mean()
    assert agree > 0.995, f"mapped agreement {agree}"
    both = mapped_ref & mapped
    df = np.abs(res[both, 0] - ref[both, 0])
    # measured at introduction: med 0.00200, p95 < 2e-2 (the 12-frame
    # mark is noisier than the 40-frame converged 0.00154); the gate
    # protects against regressions, thresholds sized to measured + margin
    assert np.median(df) < 2.5e-3, np.median(df)
    assert np.percentile(df, 95) < 2e-2, np.percentile(df, 95)
