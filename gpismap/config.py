"""Configuration for the GPIS mapping framework.

One frozen dataclass per subsystem, mirroring the reference's parameter
surface (reference: cpp/include/params.h, strct.h:135-199, GPisMap.h:29-67,
GPisMap3.h:29-81) with the exact same defaults, plus static-shape capacity
knobs (static-shape paddings) that have no counterpart in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TreeParam:
    """Spatial index resolutions (reference: strct.h:174-199, params.h:27-46)."""

    min_halfleng: float
    max_halfleng: float
    init_root_halfleng: float
    cluster_halfleng: float

    @property
    def min_halfleng_sqr(self) -> float:
        return self.min_halfleng * self.min_halfleng


# Reference: params.h:34-37 (bound at GPisMap.cpp:26-29)
TREE_2D = TreeParam(
    min_halfleng=0.2,
    max_halfleng=102.4,
    init_root_halfleng=12.8,
    cluster_halfleng=0.8,
)

# Reference: params.h:40-44 (bound at GPisMap3.cpp:28-31)
TREE_3D = TreeParam(
    min_halfleng=0.0125 / 2.0,
    max_halfleng=1.6,
    init_root_halfleng=0.4,
    cluster_halfleng=0.025,
)


@dataclasses.dataclass(frozen=True)
class ObsGPParam:
    """Observation-regression GP (reference: strct.h:135-157, params.h:99-110)."""

    scale: float = 0.5       # OU length scale (ObsGP.h:44)
    noise: float = 0.01      # observation noise (ObsGP.h:45)
    margin: float = 0.0175   # boundary margin in input units
    overlap: int = 6         # samples shared between neighbouring groups
    group_size: int = 20     # nominal samples per group


# 1D (LiDAR scan) defaults: params.h:103-105
OBSGP_1D = ObsGPParam(scale=0.5, noise=0.01, margin=0.0175, overlap=6, group_size=20)
# 2D (depth image) defaults: params.h:108-110
OBSGP_2D = ObsGPParam(scale=0.5, noise=0.01, margin=0.005, overlap=3, group_size=5)


@dataclasses.dataclass(frozen=True)
class MapperParam:
    """Online mapper settings (reference: GPisMap.h:29-67 / GPisMap3.h:48-81)."""

    dim: int
    delx: float
    fbias: float
    obs_var_thre: float
    min_position_noise: float
    min_grad_noise: float
    map_scale_param: float
    map_noise_param: float
    # 2D-only
    sensor_offset: Tuple[float, float] = (0.0, 0.0)
    angle_obs_limit: Tuple[float, float] = (-math.pi, math.pi)
    # 3D-only
    obs_skip: int = 2
    # Range gates (2D: GPisMap.cpp:31-32; 3D: params.h:77-78)
    min_range: float = 0.2
    max_range: float = 30.0
    # Support-radius multiple for cluster-GP training
    # (2D: 4.0 at GPisMap.cpp:583,608; 3D: Rtimes=2.0 at GPisMap3.cpp:26,707,733)
    gp_radius_times: float = 4.0
    # test() search half-width (2D: map_scale*4 GPisMap.cpp:680;
    # 3D: C_leng*3 GPisMap3.cpp:811) and var threshold (0.4 / 0.5)
    test_var_thre: float = 0.4

    @property
    def three_over_scale(self) -> float:
        """Gradient-prior variance 3/l^2 (reference: OnGPIS.h:47,58)."""
        return 3.0 / (self.map_scale_param * self.map_scale_param)


# Reference defaults: params.h:64-74, GPisMap.h:42-54
MAPPER_2D = MapperParam(
    dim=2,
    delx=1e-2,
    fbias=0.2,
    obs_var_thre=0.1,
    min_position_noise=1e-2,
    min_grad_noise=1e-2,
    map_scale_param=1.2,
    map_noise_param=1e-2,
    sensor_offset=(0.08, 0.0),
    angle_obs_limit=(-135.0 * math.pi / 180.0, 135.0 * math.pi / 180.0),
    min_range=0.2,
    max_range=30.0,
    gp_radius_times=4.0,
    test_var_thre=0.4,
)

# Reference defaults: params.h:77-93, GPisMap3.h:60-70
MAPPER_3D = MapperParam(
    dim=3,
    delx=1e-3,
    fbias=0.2,
    obs_var_thre=0.04,
    min_position_noise=1e-3,
    min_grad_noise=1e-2,
    map_scale_param=0.04,
    map_noise_param=5e-3,
    obs_skip=2,
    min_range=0.4,
    max_range=4.0,
    gp_radius_times=2.0,
    test_var_thre=0.5,
)


@dataclasses.dataclass(frozen=True)
class CameraParam:
    """Pinhole intrinsics (reference: GPisMap3.h:29-46)."""

    fx: float = 568.0
    fy: float = 568.0
    cx: float = 310.0
    cy: float = 224.0
    width: int = 640
    height: int = 480


# Hard-coded calibration tables from the reference mex shim
# (mexGPisMap3.cpp:30-41); index = camera id - 1.
BIGBIRD_CAMS = tuple(
    CameraParam(fx=fx, fy=fy, cx=cx, cy=cy, width=640, height=480)
    for fx, fy, cx, cy in zip(
        (570.9361, 572.3318, 568.9403, 567.9881, 572.7638),
        (570.9376, 572.3316, 568.9419, 567.9995, 572.7567),
        (306.8789, 309.9968, 308.4583, 310.5243, 310.4192),
        (238.8476, 230.6296, 225.8232, 223.9443, 214.8762),
    )
)

YCB_CAMS = tuple(
    CameraParam(fx=fx, fy=fy, cx=cx, cy=cy, width=640, height=480)
    for fx, fy, cx, cy in zip(
        (570.2590, 571.8461, 568.4464, 566.9790, 574.0641),
        (570.2636, 571.8428, 568.4494, 566.9812, 574.0598),
        (313.7235, 314.9134, 310.3805, 314.3801, 314.6690),
        (236.0783, 229.4538, 224.6232, 223.9443, 220.7985),
    )
)


@dataclasses.dataclass(frozen=True)
class CapacityParam:
    """Static-shape capacities (no reference counterpart).

    Everything under jit needs a fixed shape; these paddings bound the
    dynamic quantities. Overflow policies are documented per field.
    """

    # Max support nodes per cluster-GP (overflow: nearest-to-center kept).
    # On the reference's recordings: 2D max 73 (full sequence), 3D median
    # 125 / max 270. 128 and 320 were sized for a 128-wide matrix unit
    # (M' = M*(1+D) = 384 / 1280); not re-tuned for the H100 yet.
    gp_support: int = 128
    # Cluster cells retrained per device batch (memory chunking).
    retrain_batch: int = 64
    # Max live cluster cells with trained GPs.
    max_cells: int = 4096
    # Max nodes in the map.
    max_nodes: int = 65536
    # Tile size for segmented per-cell test evaluation: queries per tile,
    # each tile against one cell (2D 256, 3D 128, where per-cell
    # remainder padding costs more). Sized on the previous accelerator;
    # not re-tuned for the H100 yet.
    test_tile: int = 256
    # Max DISTINCT cluster cells one test batch may touch (bounds the
    # transient per-call factor buffer [max_active, M', M']).
    test_active_cells: int = 512
    # Max observation beams / rays per frame (2D scan length padding).
    max_beams: int = 512
    # Candidate-table row width (models/cluster.NeighborTable): max
    # trained cells registered per grid cell's search window (overflow:
    # counted in NeighborTable.n_overflow, surfaced as
    # stats["nbr_overflow"] by test()).
    nbr_k: int = 48


CAPACITY_2D = CapacityParam()
# retrain_batch 64: typical frames fit ONE retrain chunk, which enables
# the fused frame epilogue and its single factor-refresh dispatch.
CAPACITY_3D = CapacityParam(gp_support=320, retrain_batch=64, max_cells=4096,
                            max_nodes=131072, test_tile=128,
                            test_active_cells=320, max_beams=512,
                            nbr_k=64)
