"""Multi-device scaling layer (absent in the single-GPU reference).

SURVEY §2 'equivalents to build': a (cubes, points) device
mesh, node-parallel sharding of rotation-candidate searches, and
sequence-parallel sharding of the source-point bound reduction.
"""

from .sharding import (CUBES_AXIS, POINTS_AXIS, make_mesh,
                       single_device_mesh)
from .bnb import bnb_r3_sharded, icp_sharded

__all__ = [
    "CUBES_AXIS", "POINTS_AXIS", "make_mesh", "single_device_mesh",
    "bnb_r3_sharded", "icp_sharded",
]
