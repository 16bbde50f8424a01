"""Device-mesh construction for sharded Go-ICP.

The reference is strictly single-GPU (SURVEY §2 parallelism inventory: 32
CUDA streams + thrust reductions, no NCCL/MPI).  This scaling design adds
two mesh axes:

* ``cubes``  — node parallelism: independent rotation-candidate searches
  (inner R^3 BnBs and ICP lanes) are sharded across devices.  Pure data
  parallelism over the search frontier; the only cross-device traffic is
  the lockstep loop-termination vote.
* ``points`` — the "sequence" axis: the source-point dimension of bound
  evaluation is sharded, with per-point bound contributions reduced by
  ``psum`` across devices (SURVEY §5 long-context note).

Both axes compose: eight devices can run e.g. (cubes=4, points=2).
The cards of one host are joined all to all, so the mesh shape follows
the algorithm alone.  Axis sizes
come from EngineConfig.mesh_cubes / mesh_points or are inferred from the
available devices (all devices on the cubes axis by default, since node
parallelism has the lowest communication volume).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CUBES_AXIS = "cubes"
POINTS_AXIS = "points"


def make_mesh(n_cubes: Optional[int] = None, n_points: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a 2D (cubes, points) mesh over the given devices.

    With n_cubes=None, all remaining devices go to the cubes axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_points < 1 or n % n_points:
        raise ValueError(f"mesh_points={n_points} must divide {n} devices")
    if n_cubes is None:
        n_cubes = n // n_points
    if n_cubes * n_points != n:
        raise ValueError(
            f"mesh {n_cubes}x{n_points} != {n} available devices")
    grid = np.asarray(devices).reshape(n_cubes, n_points)
    return Mesh(grid, (CUBES_AXIS, POINTS_AXIS))


def single_device_mesh(device: Optional[jax.Device] = None) -> Mesh:
    dev = device if device is not None else jax.devices()[0]
    return Mesh(np.asarray([dev]).reshape(1, 1), (CUBES_AXIS, POINTS_AXIS))


def group_spec() -> P:
    """Sharding for per-rotation-group arrays: first axis over cubes."""
    return P(CUBES_AXIS)


def point_spec() -> P:
    """Sharding for source-point arrays: first axis over points."""
    return P(POINTS_AXIS)


def replicated_spec() -> P:
    return P()


def shard_groups(mesh: Mesh, tree):
    """Place per-group arrays (leading axis G) on the cubes axis."""
    sh = NamedSharding(mesh, P(CUBES_AXIS))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
