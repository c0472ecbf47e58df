"""Isosurface extraction sanity (marching tetrahedra)."""
import numpy as np

from gpismap.viz import marching_tetrahedra


def test_sphere_isosurface():
    n = 20
    xs = np.linspace(-1.3, 1.3, n)
    x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    f = np.sqrt(x * x + y * y + z * z) - 1.0
    sp = (xs[1] - xs[0],) * 3
    verts, faces = marching_tetrahedra(f, 0.0, spacing=sp,
                                       origin=(xs[0],) * 3)
    assert len(verts) > 500
    assert len(faces) > 1000
    r = np.linalg.norm(verts, axis=1)
    assert abs(r.mean() - 1.0) < 0.02
    assert r.std() < 0.02
    assert faces.max() < len(verts)


def test_empty_and_nan_fields():
    f = np.full((4, 4, 4), 1.0)
    v, fc = marching_tetrahedra(f, 0.0)
    assert len(v) == 0 and len(fc) == 0
    f[1, 1, 1] = np.nan
    v, fc = marching_tetrahedra(f, 0.0)
    assert len(v) == 0
    f = np.full((4, 4, 4), 1.0)
    f[1:3, 1:3, 1:3] = -1.0
    v, fc = marching_tetrahedra(f, 0.0)
    assert len(v) > 0


def test_slice_planes_geometry():
    """The two oblique slice planes match the reference construction
    (visualize_gpisMap3.m:53-68): rotations about z preserve plane 2's
    height and plane 3 passes through the translated origin line."""
    from gpismap.viz import slice_planes_3d

    planes = slice_planes_3d()
    assert len(planes) == 2
    (p2, s2), (p3, s3) = planes
    assert p2.shape == (s2[0] * s2[1], 3) and p2.dtype == np.float32
    # rotation about z leaves plane 2's z = 0.12 exactly
    np.testing.assert_allclose(p2[:, 2], 0.12, atol=1e-6)
    # plane 3: the point (0, 0, z) maps to (0.04, 0, z)
    assert p3.shape == (s3[0] * s3[1], 3)
    i = np.argmin(np.abs(p3[:, 1] + 0.0) + np.abs(p3[:, 2]))
    # grid spans y in [-0.1, 0.14], z in [0, 0.3] pre-rotation
    zs = p3[:, 2]
    np.testing.assert_allclose(zs.min(), 0.0, atol=1e-6)
    np.testing.assert_allclose(zs.max(), 0.30, atol=1e-6)


def test_plot_slices_3d_renders():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gpismap.viz import plot_slices_3d, slice_planes_3d

    planes = slice_planes_3d()
    results = [np.zeros((len(p), 8), np.float32) for p, _ in planes]
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    mp = plot_slices_3d(ax, planes, results)
    assert mp is not None
    plt.close(fig)
