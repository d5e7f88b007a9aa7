"""Sharded TGV-2 over the canonical (z, t) mesh.

``axes='2d'`` TGV (solvers/tgv.py) couples pixels only within a
(N_row, N_col) slice, so the volume shards over (z, t) with ZERO halo
communication — each shard solves its slices independently (the same
per-slice subproblem as single-device, hence slot-exact iterates by
construction) and the only collective is one scalar ``psum`` per iteration
for the separable objective.

``axes='3d'``/``'4d'`` couple z (and t) across shard boundaries: call
:func:`pytv4d_tpu.solvers.tgv.tgv_denoise` on a sharded input and XLA's
SPMD partitioner inserts the one-plane halo ``collective-permute``s for
the jnp stencils automatically
(tests/test_sharding.py::test_tgv_gspmd_3d_4d).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import T_AXIS, Z_AXIS, d_volume_spec, volume_spec


def tgv_denoise_sharded(
    x,
    mesh: Mesh,
    n_iter: int = 300,
    alpha1: float = 25.0,
    alpha0: float = 50.0,
    sigma_tau_split: float = 1.0,
    compute_loss: bool = True,
    shard_time: bool = True,
    norm: str = "iso",
    huber_delta: float = 1.0,
):
    """``axes='2d'`` TGV-2 denoising under ``shard_map`` on ``mesh``.

    Input should be placed with ``parallel.mesh.shard_volume``; returns a
    ``TGVResult`` with the same (z, t)-sharded layout.  Communication: one
    scalar psum per iteration (none with ``compute_loss=False``)."""
    from ..solvers.tgv import TGVResult, tgv_denoise

    if T_AXIS not in mesh.shape:  # pure-z mesh: nothing to shard over t
        shard_time = False
    vol = volume_spec(shard_time)
    wspec = d_volume_spec(shard_time)
    axes = (Z_AXIS, T_AXIS) if shard_time else (Z_AXIS,)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(vol,),
        out_specs=(vol, wspec, P()), check_vma=False,
    )
    def fn(x_local):
        res = tgv_denoise(
            x_local, n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
            sigma_tau_split=sigma_tau_split, axes="2d",
            compute_loss=compute_loss, norm=norm,
            huber_delta=huber_delta,
        )
        loss = lax.psum(res.loss, axes) if compute_loss else res.loss
        return res.x, res.w, loss

    x_out, w_out, loss = fn(jnp.asarray(x))
    return TGVResult(x=x_out, w=w_out, loss=loss)
