"""gpismap — a Gaussian-Process Implicit Surface mapping framework in
JAX (accelerator: NVIDIA H100), re-designed from scratch with the capabilities
of the GPisMap reference (online continuous SDF mapping from 2D LiDAR /
3D depth streams, with analytic gradients and variances).
"""

__version__ = "0.1.0"

from .api import GPisMap2D  # noqa: F401
from .api3d import GPisMap3D  # noqa: F401
from .config import (  # noqa: F401
    CAPACITY_2D,
    CAPACITY_3D,
    MAPPER_2D,
    MAPPER_3D,
    OBSGP_1D,
    OBSGP_2D,
    TREE_2D,
    TREE_3D,
    BIGBIRD_CAMS,
    YCB_CAMS,
    CameraParam,
    CapacityParam,
    MapperParam,
    ObsGPParam,
    TreeParam,
)
