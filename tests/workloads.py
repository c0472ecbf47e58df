"""Small seeded sequences for the CPU tests, from the generators in
gpismap.datasets (the production workloads cut to a few frames and, in
3D, a quarter-resolution camera and a smaller support capacity)."""
import dataclasses

from gpismap import datasets
from gpismap.config import CAPACITY_3D, CameraParam

# BigBIRD camera 1 intrinsics at a quarter of the resolution
SMALL_CAM = CameraParam(fx=570.9361 / 4, fy=570.9376 / 4,
                        cx=306.8789 / 4, cy=238.8476 / 4,
                        width=160, height=120)
CAP_3D_SMALL = dataclasses.replace(CAPACITY_3D, gp_support=64)


def frames_2d(n: int, seed: int = 0):
    """[(thetas, ranges, pose6)] of the first n floor-plan scans."""
    return [(f.thetas, f.ranges, f.pose)
            for f in datasets.floor_frames(seed, n)]


def frames_3d(n: int, seed: int = 0):
    """[(depth, pose12, camera)] of the first n table-top frames."""
    return [(f.depth, f.pose, SMALL_CAM)
            for f in datasets.tabletop_frames(seed, n, camera=SMALL_CAM)]
