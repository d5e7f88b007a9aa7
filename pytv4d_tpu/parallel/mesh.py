"""Device-mesh construction and sharding layouts.

The reference is strictly single-device (SURVEY.md section 2.5: hardcoded
``.cuda()``, zero distributed code).  Its own layout comment is the sharding
blueprint: the ``(Nz, M, N, N)`` order is chosen "since the CT operations can
be decomposed easily along z" (``README.md:235``) — so the canonical mesh here
is ``('z', 't')`` with the volume sharded over its two leading axes.  All TV
stencils are pads/slices, so XLA's SPMD partitioner inserts the one-pixel halo
exchanges (``collective-permute``) automatically when the jitted ops
run on sharded inputs; ``parallel.halo`` provides the explicit ``shard_map``
equivalent for hand-scheduled overlap.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Z_AXIS = "z"
T_AXIS = "t"


def make_mesh(
    z: int = 0,
    t: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(z, t)`` mesh.  ``z=0`` means "all remaining devices"."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if z == 0:
        if n % t:
            raise ValueError(f"{n} devices not divisible by t={t}")
        z = n // t
    if z * t != n:
        raise ValueError(f"mesh {z}x{t} != {n} devices")
    dev_array = np.asarray(devices).reshape(z, t)
    return Mesh(dev_array, (Z_AXIS, T_AXIS))


def volume_spec(shard_time: bool = True) -> P:
    """PartitionSpec for a ``(Nz, M, N_row, N_col)`` volume."""
    return P(Z_AXIS, T_AXIS if shard_time else None, None, None)


def d_volume_spec(shard_time: bool = True) -> P:
    """PartitionSpec for a ``(Nz, Nd, M, N_row, N_col)`` difference volume —
    the channel axis is replicated, z/t sharded like the volume."""
    return P(Z_AXIS, None, T_AXIS if shard_time else None, None, None)


def volume_sharding(mesh: Mesh, shard_time: bool = True) -> NamedSharding:
    # tolerate pure-z meshes (no 't' axis) — natural for z-coupled solvers
    return NamedSharding(mesh, volume_spec(shard_time
                                           and T_AXIS in mesh.shape))


def d_volume_sharding(mesh: Mesh, shard_time: bool = True) -> NamedSharding:
    return NamedSharding(mesh, d_volume_spec(shard_time
                                             and T_AXIS in mesh.shape))


def shard_volume(x, mesh: Mesh, shard_time: bool = True):
    """Place a volume onto the mesh with the canonical (z, t) sharding."""
    return jax.device_put(x, volume_sharding(mesh, shard_time))
