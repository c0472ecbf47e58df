"""Workloads: seeded scene generators, plus loaders for the reference data.

The generators are what the repository runs on. Each one ray-casts an
analytic scene whose signed distance (`floor_plan_sdf`, `tabletop_sdf`) is
the ground truth:

  2D: a polygonal floor plan seen by a planar LiDAR shaped like a Hokuyo
      UTM-30LX (1081 beams over 270 degrees) along a smooth 28-frame
      trajectory, inside the extent of `gazebo_test_grid()`.
  3D: analytic objects on a table top seen as 640x480 depth through the
      `config.BIGBIRD_CAMS` intrinsics from an orbit of 40 poses, inside
      the volume of `bigbird_test_grid()`.

The reference's own recordings (gazebo1.mat, bigbird "detergent") load from
$GPISMAP_DATA when someone has them; nothing in the repository needs them.
"""
from __future__ import annotations

import math
import os
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from .config import BIGBIRD_CAMS, CameraParam


class Scan2D(NamedTuple):
    frame: int
    thetas: np.ndarray   # [B]
    ranges: np.ndarray   # [B]
    pose: np.ndarray     # [6] = [tx, ty, R00, R10, R01, R11] column-major


class Depth3D(NamedTuple):
    frame: int
    cam_id: int          # 1-based camera id (bigbird tables)
    depth: np.ndarray    # [H, W] float32 meters
    pose: np.ndarray     # [12] = [t(3), R column-major(9)]


# ---------------------------------------------------------------------------
# 2D: floor plan + planar LiDAR
# ---------------------------------------------------------------------------

# UTM-30LX: 1081 beams over 270 degrees (0.25 degree steps), 30 m range
LIDAR_BEAMS = 1081
LIDAR_FOV = 1.5 * math.pi
LIDAR_SIGMA = 0.01            # range noise std [m]
SENSOR_OFFSET_2D = (0.08, 0.0)   # MAPPER_2D.sensor_offset


def _box(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1),
            (x0, y1, x0, y0)]


def floor_plan_segments() -> np.ndarray:
    """Wall segments [S, 4] = (x0, y0, x1, y1) of the 2D floor plan: an
    outer shell inside x in [-5, 20], y in [-15, 5], interior walls with
    door gaps, and a few boxes and pillars (octagons)."""
    segs = _box(-4.0, -14.0, 19.0, 4.0)
    segs += [(6.0, 4.0, 6.0, -8.7), (6.0, -10.5, 6.0, -14.0),  # doors on
             (-4.0, -6.0, 3.6, -6.0), (5.4, -6.0, 6.0, -6.0),  # the path
             (6.0, -8.0, 6.8, -8.0), (8.6, -8.0, 19.0, -8.0),
             (12.5, 4.0, 12.5, 0.0)]
    segs += _box(-1.5, 0.0, 0.5, 1.2)          # desks / cabinets
    segs += _box(9.0, -12.5, 10.2, -10.5)
    segs += _box(15.0, 0.5, 17.5, 1.7)
    segs += _box(-2.8, -12.0, -1.0, -10.8)
    for cx, cy, r in ((9.5, -3.0, 0.35), (15.5, -5.0, 0.35),
                      (0.0, -9.5, 0.3)):        # pillars
        a = np.arange(9) * (2 * np.pi / 8)
        px, py = cx + r * np.cos(a), cy + r * np.sin(a)
        segs += [(px[i], py[i], px[i + 1], py[i + 1]) for i in range(8)]
    return np.asarray(segs, np.float64)


def floor_plan_sdf(pts: np.ndarray) -> np.ndarray:
    """Unsigned distance [N] from 2D points to the nearest wall segment
    (walls are thin, so the surface is their zero level set)."""
    p = np.asarray(pts, np.float64)[:, None, :]
    s = floor_plan_segments()
    a, b = s[None, :, :2], s[None, :, 2:]
    ab = b - a
    t = np.clip(np.sum((p - a) * ab, -1) / np.sum(ab * ab, -1), 0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    return np.sqrt(np.min(np.sum(d * d, -1), axis=1))


def _cast_2d(origin: np.ndarray, dirs: np.ndarray, segs: np.ndarray):
    """Nearest ray-segment hit distance [B] (inf where nothing is hit)."""
    a, e = segs[:, :2], segs[:, 2:] - segs[:, :2]
    oa = a[None, :, :] - origin[None, None, :]           # [1, S, 2]
    den = dirs[:, None, 0] * e[None, :, 1] - dirs[:, None, 1] * e[None, :, 0]
    safe = np.where(np.abs(den) > 1e-12, den, 1.0)
    t = (oa[..., 0] * e[None, :, 1] - oa[..., 1] * e[None, :, 0]) / safe
    u = (oa[..., 0] * dirs[:, None, 1] - oa[..., 1] * dirs[:, None, 0]) / safe
    hit = (np.abs(den) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    return np.min(np.where(hit, t, np.inf), axis=1)


def _floor_trajectory(n_frames: int):
    """Smooth closed-form path through three rooms: positions [N, 2] and
    headings [N] tangent to the path."""
    s = np.linspace(0.0, 1.0, n_frames)
    x = -1.0 + 15.0 * s + 1.2 * np.sin(2.0 * np.pi * s)
    y = -2.0 - 7.0 * np.sin(np.pi * s) ** 2 + 1.0 * np.sin(3.0 * np.pi * s)
    ds = 1e-4
    x1 = -1.0 + 15.0 * (s + ds) + 1.2 * np.sin(2.0 * np.pi * (s + ds))
    y1 = (-2.0 - 7.0 * np.sin(np.pi * (s + ds)) ** 2
          + 1.0 * np.sin(3.0 * np.pi * (s + ds)))
    return np.stack([x, y], -1), np.arctan2(y1 - y, x1 - x)


def floor_frames(seed: int = 0, n_frames: int = 28,
                 n_beams: int = LIDAR_BEAMS,
                 max_range: float = 30.0) -> Iterator[Scan2D]:
    """Seeded planar-LiDAR sequence over the floor plan.

    Beams without a return within `max_range` report 0 (range-gated out
    by the mapper, as a real scanner's no-return value is). Ranges carry
    N(0, LIDAR_SIGMA^2) noise drawn from `seed`."""
    rng = np.random.default_rng(seed)
    segs = floor_plan_segments()
    thetas = np.linspace(-LIDAR_FOV / 2, LIDAR_FOV / 2, n_beams)
    pos, heading = _floor_trajectory(n_frames)
    off = np.asarray(SENSOR_OFFSET_2D)
    for i in range(n_frames):
        c, s = math.cos(heading[i]), math.sin(heading[i])
        rot = np.array([[c, -s], [s, c]])
        origin = pos[i] + rot @ off
        ang = thetas + heading[i]
        r = _cast_2d(origin, np.stack([np.cos(ang), np.sin(ang)], -1), segs)
        r = r + rng.normal(0.0, LIDAR_SIGMA, n_beams)
        r = np.where(np.isfinite(r) & (r < max_range), r, 0.0)
        pose = np.array([pos[i, 0], pos[i, 1], c, s, -s, c], np.float32)
        yield Scan2D(frame=i, thetas=thetas.astype(np.float32),
                     ranges=r.astype(np.float32), pose=pose)


def gazebo_test_grid(intv: float = 0.1):
    """The 2D evaluation grid (reference demo_gpisMap.m:29-35): meshgrid
    over [xmin+intv : intv : xmax-intv] x [ymin+intv : ...] on the
    x in [-5, 20], y in [-15, 5] extent — 49,551 points at 0.1 m."""
    xs = np.arange(-5 + intv, 20 - intv / 2, intv, dtype=np.float32)
    ys = np.arange(-15 + intv, 5 - intv / 2, intv, dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    return np.stack([xg.reshape(-1), yg.reshape(-1)], -1), xg.shape


# ---------------------------------------------------------------------------
# 3D: objects on a table top + depth camera
# ---------------------------------------------------------------------------

DEPTH_SIGMA = 5e-4            # depth noise std [m]
TABLE_RADIUS = 0.2            # table-top disk at z = 0
# primitives: a box (carton), a sphere and an upright cylinder (can)
_BOX_C = np.array([0.045, -0.01, 0.1])
_BOX_H = np.array([0.035, 0.06, 0.1])
_SPHERE_C = np.array([-0.02, 0.08, 0.045])
_SPHERE_R = 0.045
_CYL_C = np.array([0.09, 0.09])       # axis (x, y); z from 0 to _CYL_H
_CYL_R, _CYL_H = 0.03, 0.14
OBJECT_CENTER = np.array([0.03, 0.02, 0.1])


def tabletop_sdf(pts: np.ndarray) -> np.ndarray:
    """Signed distance [N] to the union of the table top (a thin disk of
    TABLE_RADIUS at z = 0) and the three objects standing on it."""
    p = np.asarray(pts, np.float64)
    q = np.abs(p - _BOX_C) - _BOX_H
    box = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
           + np.minimum(np.max(q, -1), 0.0))
    sph = np.linalg.norm(p - _SPHERE_C, axis=-1) - _SPHERE_R
    rad = np.linalg.norm(p[:, :2] - _CYL_C, axis=-1) - _CYL_R
    hz = np.abs(p[:, 2] - _CYL_H / 2) - _CYL_H / 2
    cq = np.stack([rad, hz], -1)
    cyl = (np.linalg.norm(np.maximum(cq, 0.0), axis=-1)
           + np.minimum(np.max(cq, -1), 0.0))
    rr = np.linalg.norm(p[:, :2], axis=-1)
    table = np.sqrt(np.maximum(rr - TABLE_RADIUS, 0.0) ** 2 + p[:, 2] ** 2)
    return np.minimum(np.minimum(box, sph), np.minimum(cyl, table))


def _cast_3d(o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Nearest hit distance [N] along rays o + t d (inf where none)."""
    inf = np.inf
    best = np.full(d.shape[0], inf)

    # box: slab method
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t0 = (_BOX_C - _BOX_H - o) * inv
        t1 = (_BOX_C + _BOX_H - o) * inv
    tn = np.max(np.minimum(t0, t1), -1)
    tf = np.min(np.maximum(t0, t1), -1)
    ok = (tf >= tn) & (tn > 0)
    best = np.where(ok, np.minimum(best, tn), best)

    # sphere
    oc = o - _SPHERE_C
    b = np.sum(d * oc, -1)
    c = np.sum(oc * oc) - _SPHERE_R ** 2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    best = np.where((disc >= 0) & (t > 0), np.minimum(best, t), best)

    # cylinder side + top cap
    ox, oy = o[0] - _CYL_C[0], o[1] - _CYL_C[1]
    a2 = d[:, 0] ** 2 + d[:, 1] ** 2
    b2 = ox * d[:, 0] + oy * d[:, 1]
    c2 = ox * ox + oy * oy - _CYL_R ** 2
    disc = b2 * b2 - a2 * c2
    t = (-b2 - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(a2, 1e-12)
    z = o[2] + t * d[:, 2]
    ok = (disc >= 0) & (t > 0) & (z >= 0) & (z <= _CYL_H)
    best = np.where(ok, np.minimum(best, t), best)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (_CYL_H - o[2]) / d[:, 2]
    px, py = ox + t * d[:, 0], oy + t * d[:, 1]
    ok = (t > 0) & (px * px + py * py <= _CYL_R ** 2)
    best = np.where(ok, np.minimum(best, t), best)

    # table-top disk at z = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -o[2] / d[:, 2]
    px, py = o[0] + t * d[:, 0], o[1] + t * d[:, 1]
    ok = (t > 0) & (px * px + py * py <= TABLE_RADIUS ** 2)
    return np.where(ok, np.minimum(best, t), best)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-from-camera rotation: z forward to the target, x right,
    y down (the pinhole convention of mapper3d.preprocess_3d)."""
    zc = target - eye
    zc = zc / np.linalg.norm(zc)
    xc = np.cross(zc, np.array([0.0, 0.0, 1.0]))
    xc = xc / np.linalg.norm(xc)
    yc = np.cross(zc, xc)
    return np.stack([xc, yc, zc], axis=1)


def tabletop_frames(seed: int = 0, n_frames: int = 40,
                    cam_ids: Optional[List[int]] = None,
                    camera: Optional[CameraParam] = None
                    ) -> Iterator[Depth3D]:
    """Seeded depth sequence: an orbit of `n_frames` poses around the
    table at 0.75 m radius, camera height cycling over three levels,
    cameras cycling [1 2 3 4 3 2] through `config.BIGBIRD_CAMS` (the
    reference 3D demo's schedule, demo_gpisMap3.m:33-47).

    `camera` overrides the intrinsics for every frame (tests use a small
    image); frames then carry cam_id 0. Pixels that see nothing report
    depth 0; the rest carry N(0, DEPTH_SIGMA^2) noise drawn from `seed`."""
    rng = np.random.default_rng(seed)
    cycle = cam_ids or [1, 2, 3, 4, 3, 2]
    heights = (0.25, 0.45, 0.6)
    for i in range(n_frames):
        cid = cycle[i % len(cycle)]
        cam = camera or BIGBIRD_CAMS[cid - 1]
        ang = 2.0 * np.pi * i / n_frames
        eye = np.array([0.75 * np.cos(ang), 0.75 * np.sin(ang),
                        heights[i % len(heights)]])
        rot = _look_at(eye, OBJECT_CENTER)
        u = (np.arange(cam.width) - cam.cx) / cam.fx
        v = (np.arange(cam.height) - cam.cy) / cam.fy
        dl = np.stack(np.broadcast_arrays(u[None, :], v[:, None], 1.0), -1)
        dl = dl.reshape(-1, 3)                         # (u, v, 1) per pixel
        dw = dl @ rot.T
        norm = np.linalg.norm(dw, axis=-1)
        t = _cast_3d(eye, dw / norm[:, None])
        z = t / norm                                   # depth along z_cam
        z = z + rng.normal(0.0, DEPTH_SIGMA, z.shape)
        z = np.where(np.isfinite(z), z, 0.0).reshape(cam.height, cam.width)
        pose = np.concatenate([eye, rot.reshape(-1, order="F")])
        yield Depth3D(frame=i, cam_id=0 if camera else cid,
                      depth=z.astype(np.float32),
                      pose=pose.astype(np.float32))


def bigbird_test_grid(intv: float = 0.01):
    """The 3D volume grid (reference demo_gpisMap3.m:37-38): 21 x 25 x 29
    = 15,225 points at 1 cm around the objects."""
    xs = np.arange(-0.07, 0.13 + intv / 2, intv, dtype=np.float32)
    ys = np.arange(-0.1, 0.14 + intv / 2, intv, dtype=np.float32)
    zs = np.arange(0.0, 0.28 + intv / 2, intv, dtype=np.float32)
    xg, yg, zg = np.meshgrid(xs, ys, zs)
    return (np.stack([xg.reshape(-1), yg.reshape(-1), zg.reshape(-1)], -1),
            xg.shape)


# ---------------------------------------------------------------------------
# The reference's recordings ($GPISMAP_DATA)
# ---------------------------------------------------------------------------

def _data_dir() -> str:
    path = os.environ.get("GPISMAP_DATA")
    if not path:
        raise FileNotFoundError(
            "set GPISMAP_DATA to the reference data directory")
    return path


def load_gazebo(path: str | None = None):
    """gazebo1.mat: poses [N, 3] (x, y, phi), thetas [B], ranges [N, B]."""
    import scipy.io as sio
    path = path or os.path.join(_data_dir(), "2D", "gazebo1.mat")
    d = sio.loadmat(path)
    return (np.asarray(d["poses"], np.float32),
            np.asarray(d["thetas"], np.float32).reshape(-1),
            np.asarray(d["ranges"], np.float32))


def gazebo_frames(path: str | None = None, init_frame: int = 101,
                  skip: int = 100) -> Iterator[Scan2D]:
    """The reference demo frame schedule (demo_gpisMap.m:37-40): frames
    initframe : skip : last, 1-based inclusive."""
    poses, thetas, ranges = load_gazebo(path)
    n = poses.shape[0]
    last = ((n - init_frame) // skip) * skip + init_frame
    for nf in range(init_frame, last + 1, skip):
        i = nf - 1                      # matlab 1-based
        x, y, phi = poses[i]
        c, s = np.cos(phi), np.sin(phi)
        pose = np.array([x, y, c, s, -s, c], np.float32)
        yield Scan2D(frame=nf, thetas=thetas, ranges=ranges[i], pose=pose)


def bigbird_frames(path: str | None = None) -> Iterator[Depth3D]:
    """The reference 3D demo schedule (demo_gpisMap3.m:33-47): FrameNums
    [93:3:359, 3:3:90] stepped by 3 with cams cycling [1 2 3 4 3 2];
    depth PNGs are 0.1 mm units."""
    from PIL import Image
    path = path or os.path.join(_data_dir(), "3D", "bigbird_detergent")
    poses = np.loadtxt(os.path.join(path, "pose", "poses.txt"),
                       dtype=np.float32)
    frame_nums = list(range(93, 360, 3)) + list(range(3, 91, 3))
    cam_ids = ([1, 2, 3, 4, 3, 2] * 30)
    count = 0
    for k in range(0, len(frame_nums), 3):
        frm = frame_nums[k]
        cam = cam_ids[count]
        count += 1
        f = os.path.join(path, "masked_depth", f"frame{frm}_cam{cam}.png")
        depth = np.asarray(Image.open(f), np.float32) * 1e-4
        row = poses[count - 1]
        # matlab: T = reshape(row, 4, 4) column-major; R = T(1:3,1:3);
        # t = T(4,1:3)' — pose to mex is [t' reshape(R,1,[])]
        t = np.array([row[3], row[7], row[11]], np.float32)
        r_colmajor = np.array([row[0], row[1], row[2],
                               row[4], row[5], row[6],
                               row[8], row[9], row[10]], np.float32)
        yield Depth3D(frame=frm, cam_id=cam, depth=depth,
                      pose=np.concatenate([t, r_colmajor]))
