"""Seeded workload generators (gpismap.datasets): determinism, shapes
and ground truth — every observed hit lies on the analytic surface."""
import numpy as np
import pytest

from gpismap import datasets
from gpismap.config import BIGBIRD_CAMS, MAPPER_2D, MAPPER_3D


def _hits_2d(fr):
    ok = (fr.ranges > MAPPER_2D.min_range) & (fr.ranges < MAPPER_2D.max_range)
    rot = fr.pose[2:6].reshape(2, 2, order="F")
    loc = np.stack([fr.ranges * np.cos(fr.thetas),
                    fr.ranges * np.sin(fr.thetas)], -1)
    loc = loc + np.asarray(MAPPER_2D.sensor_offset)
    return (loc @ rot.T + fr.pose[:2])[ok]


def _hits_3d(fr, cam):
    z = fr.depth
    ok = (z > MAPPER_3D.min_range) & (z < MAPPER_3D.max_range)
    v, u = np.mgrid[0:cam.height, 0:cam.width]
    loc = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z,
                    z], -1)[ok]
    rot = fr.pose[3:12].reshape(3, 3, order="F")
    return loc @ rot.T + fr.pose[:3]


@pytest.mark.parametrize("gen", ["floor", "tabletop"])
def test_generators_are_seeded(gen):
    fn = (datasets.floor_frames if gen == "floor"
          else datasets.tabletop_frames)
    a = list(fn(3, 2))
    b = list(fn(3, 2))
    c = list(fn(4, 2))
    for x, y, z in zip(a, b, c):
        for i in range(len(x)):
            np.testing.assert_array_equal(x[i], y[i])
        np.testing.assert_array_equal(x.pose, z.pose)   # noise only
    data = "ranges" if gen == "floor" else "depth"
    assert not np.array_equal(getattr(a[0], data), getattr(c[0], data))


def test_floor_frames_shape_and_surface():
    frames = list(datasets.floor_frames(0))
    assert len(frames) == 28
    fr = frames[0]
    assert fr.thetas.shape == fr.ranges.shape == (datasets.LIDAR_BEAMS,)
    assert fr.thetas[0] == pytest.approx(-0.75 * np.pi)
    assert fr.thetas[-1] == pytest.approx(0.75 * np.pi)
    pts = np.concatenate([_hits_2d(f) for f in frames[::7]])
    assert len(pts) > 3000
    sdf = datasets.floor_plan_sdf(pts)
    # range noise is 1 cm: hits sit on the walls up to it
    assert np.median(sdf) < 0.01 and np.percentile(sdf, 99) < 0.04
    xq, shape = datasets.gazebo_test_grid()
    assert xq.shape == (49551, 2) and shape == (199, 249)
    # the whole plan lies inside the grid's extent
    seg = datasets.floor_plan_segments()
    assert seg[:, 0::2].min() > -5 and seg[:, 0::2].max() < 20
    assert seg[:, 1::2].min() > -15 and seg[:, 1::2].max() < 5


def test_tabletop_frames_shape_and_surface():
    frames = list(datasets.tabletop_frames(0, 6))
    assert len(frames) == 6
    assert [f.cam_id for f in frames] == [1, 2, 3, 4, 3, 2]
    pts = []
    for f in frames[:2]:
        cam = BIGBIRD_CAMS[f.cam_id - 1]
        assert f.depth.shape == (cam.height, cam.width) == (480, 640)
        pts.append(_hits_3d(f, cam)[::50])
    pts = np.concatenate(pts)
    assert len(pts) > 1000
    sdf = np.abs(datasets.tabletop_sdf(pts))
    # depth noise is 0.5 mm
    assert np.median(sdf) < 1e-3 and np.percentile(sdf, 99) < 3e-3
    # the scene fits the octree (TREE_3D.max_halfleng = 1.6 m) and the
    # objects sit inside the 15,225-point volume grid
    assert np.abs(pts).max() < 1.6
    xq, shape = datasets.bigbird_test_grid()
    assert xq.shape == (15225, 3)
    inside = datasets.tabletop_sdf(xq) < 0
    assert inside.sum() > 100


def test_reference_loaders_need_the_data_dir(monkeypatch):
    monkeypatch.delenv("GPISMAP_DATA", raising=False)
    with pytest.raises(FileNotFoundError):
        next(datasets.gazebo_frames())
    with pytest.raises(FileNotFoundError):
        next(datasets.bigbird_frames())
