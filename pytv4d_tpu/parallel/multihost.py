"""Multi-host initialization and mesh construction (SURVEY.md section 5
"Distributed communication backend": the reference has none; the jax analog of
NCCL/MPI bootstrap is ``jax.distributed.initialize`` + a global device mesh).

Usage on each host of a multi-host GPU or CPU cluster:

    from pytv4d_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.global_mesh(t=2)            # (z, t) over ALL hosts' devices
    x = multihost.host_local_to_global(mesh, x_local)

``parallel.halo``'s ppermute ring and the GSPMD path are both
mesh-agnostic: XLA routes the halo exchanges over whatever links join the
devices.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import make_mesh, volume_sharding


_initialized = False

# Environment variables whose presence means "this process is part of a
# cluster" — a bootstrap failure is then a configuration error, never
# something to paper over with single-process execution.
_CLUSTER_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES",
    "JAX_PROCESS_ID",
)


def cluster_configured() -> bool:
    """True when the environment declares a multi-process cluster."""
    return any(os.environ.get(var) for var in _CLUSTER_ENV_VARS)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the jax distributed runtime.  Pass the coordinator address,
    process count and this process's id explicitly (or set
    JAX_COORDINATOR_ADDRESS etc.).  Safe to call twice.

    A failed bootstrap RAISES whenever a cluster was requested (explicit
    arguments or cluster env vars): silently degrading to single-process
    would let every downstream mesh/sharding computation run on a
    wrong-shaped mesh and produce wrong results.  Single-process fallback
    happens only when nothing in the environment asked for a cluster.

    Must run before any backend use — do NOT query jax.devices()/
    process_count() first (that would initialize a single-process backend
    and the distributed bootstrap would be ignored)."""
    global _initialized
    if _initialized:
        return
    cluster_requested = coordinator_address is not None or cluster_configured()
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
        _initialized = True
    except (ValueError, RuntimeError) as e:
        if "already" in str(e).lower():
            _initialized = True
            return
        if cluster_requested:
            raise RuntimeError(
                "jax.distributed.initialize failed although a cluster was "
                "configured (explicit coordinator_address or one of "
                f"{_CLUSTER_ENV_VARS}); refusing to silently degrade to "
                "single-process execution"
            ) from e
        # single-process environment without any cluster configuration
        _initialized = True


def global_mesh(z: int = 0, t: int = 1):
    """A (z, t) mesh over every device of every process."""
    return make_mesh(z=z, t=t, devices=jax.devices())


def host_local_to_global(mesh, x_local, spec=None):
    """Assemble per-host blocks (split along z) into one global sharded
    array.  Each host passes its own z-contiguous block.  ``spec`` defaults
    to the canonical volume PartitionSpec; pass e.g.
    ``d_volume_sharding(mesh).spec`` for difference volumes."""
    from jax.experimental import multihost_utils

    if spec is None:
        spec = volume_sharding(mesh).spec
    return multihost_utils.host_local_array_to_global_array(
        x_local, mesh, spec
    )


def global_to_host_local(mesh, x_global, spec=None):
    from jax.experimental import multihost_utils

    if spec is None:
        spec = volume_sharding(mesh).spec
    return multihost_utils.global_array_to_host_local_array(
        x_global, mesh, spec
    )
