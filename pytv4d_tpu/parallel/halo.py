"""Explicit shard_map halo-exchange path: D / D_T / tv / CP over a (z, t)
device mesh.

The domain-decomposition analog of ring attention for stencils (SURVEY.md
section 5 "long-context"): each device owns a contiguous block of z-slices
(and optionally time frames), exchanges ONE boundary plane per direction per
operator application via ``lax.ppermute``, and reduces norms/losses
with ``psum``.  Communication volume per CP iteration is 2 planes of
``(M, N, N)`` per z-neighbor pair — O(1/Nz_local) of the compute, so weak
scaling is near-linear.

Correctness contract (SURVEY.md section 7 "hard parts" item 2): the sharded
operators are *slot-exact* with the single-device path — boundary slots that
are zero globally are masked on the owning shard — so the adjointness oracle
``<Y, D X> == <D^T Y, X>`` holds on the sharded path to fp precision, and
solver iterates are bitwise-comparable (up to reduction order) with the
unsharded solver.

XLA's GSPMD partitioner produces the same collectives automatically for the
plain jnp ops (``parallel.mesh``); this module exists for explicit control
of where the exchanges happen.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.config import TVConfig
from ..core.schemes import BWD, FWD, channel_weight, scheme_channels
from ..ops.operators import _sl, d_channel, dt_channel
from .mesh import T_AXIS, Z_AXIS

__all__ = [
    "sharded_D",
    "sharded_D_T",
    "sharded_tv_and_subgrad",
    "sharded_cp_step",
    "make_sharded_cp_solver",
]


def _plane_from_left(x, axis: int, axis_name: str, n: int):
    """Left neighbor's last plane (zeros on the first shard)."""
    plane = x[_sl(x.ndim, axis, -1, None)]
    return lax.ppermute(plane, axis_name, [(i, i + 1) for i in range(n - 1)])


def _plane_from_right(x, axis: int, axis_name: str, n: int):
    """Right neighbor's first plane (zeros on the last shard)."""
    plane = x[_sl(x.ndim, axis, 0, 1)]
    return lax.ppermute(plane, axis_name, [(i + 1, i) for i in range(n - 1)])


def _zero_slot(x, axis: int, slot: int, when):
    """Multiply one slice along ``axis`` by 0 where ``when`` (a traced bool)."""
    keep = jnp.where(when, jnp.zeros((), x.dtype), jnp.ones((), x.dtype))
    sl = _sl(x.ndim, axis, slot, slot + 1 if slot != -1 else None)
    return x.at[sl].multiply(keep)


def _is_first(axis_name):
    return lax.axis_index(axis_name) == 0


def _is_last(axis_name, n):
    return lax.axis_index(axis_name) == n - 1


def sharded_d_channel(x, axis: int, kind: str, axis_name: Optional[str], n: int):
    """One difference channel on a shard: 1-plane halo + global-boundary
    masking.  Falls back to the local stencil when the axis is unsharded."""
    if axis_name is None or n == 1:
        return d_channel(jnp, x, axis, kind)
    if kind == FWD:
        ext = jnp.concatenate([x, _plane_from_right(x, axis, axis_name, n)], axis)
        d = ext[_sl(x.ndim, axis, 1, None)] - ext[_sl(x.ndim, axis, None, -1)]
        return _zero_slot(d, axis, -1, _is_last(axis_name, n))
    if kind == BWD:
        ext = jnp.concatenate([_plane_from_left(x, axis, axis_name, n), x], axis)
        d = ext[_sl(x.ndim, axis, 1, None)] - ext[_sl(x.ndim, axis, None, -1)]
        return _zero_slot(d, axis, 0, _is_first(axis_name))
    left = _plane_from_left(x, axis, axis_name, n)
    right = _plane_from_right(x, axis, axis_name, n)
    ext = jnp.concatenate([left, x, right], axis)
    d = ext[_sl(x.ndim, axis, 2, None)] - ext[_sl(x.ndim, axis, None, -2)]
    d = _zero_slot(d, axis, 0, _is_first(axis_name))
    return _zero_slot(d, axis, -1, _is_last(axis_name, n))


def sharded_dt_channel(y, axis: int, kind: str, axis_name: Optional[str], n: int):
    """Adjoint scatter of one channel on a shard.  Valid-slot masking happens
    *before* the halo exchange so cross-edge contributions are exact."""
    if axis_name is None or n == 1:
        return dt_channel(jnp, y, axis, kind)
    nd = y.ndim
    if kind == FWD:
        yv = _zero_slot(y, axis, -1, _is_last(axis_name, n))
        ext = jnp.concatenate([_plane_from_left(yv, axis, axis_name, n), yv], axis)
        return ext[_sl(nd, axis, None, -1)] - yv
    if kind == BWD:
        yv = _zero_slot(y, axis, 0, _is_first(axis_name))
        ext = jnp.concatenate([yv, _plane_from_right(yv, axis, axis_name, n)], axis)
        return yv - ext[_sl(nd, axis, 1, None)]
    yv = _zero_slot(y, axis, 0, _is_first(axis_name))
    yv = _zero_slot(yv, axis, -1, _is_last(axis_name, n))
    left = _plane_from_left(yv, axis, axis_name, n)
    right = _plane_from_right(yv, axis, axis_name, n)
    return (
        jnp.concatenate([left, yv], axis)[_sl(nd, axis, None, -1)]
        - jnp.concatenate([yv, right], axis)[_sl(nd, axis, 1, None)]
    )


class _ShardCtx:
    """Static per-mesh context: which volume axes are sharded and how wide."""

    def __init__(self, mesh: Mesh, shard_time: bool):
        self.nz = mesh.shape[Z_AXIS]
        self.nt = mesh.shape[T_AXIS] if shard_time else 1
        # volume axis -> (mesh axis name, size); axes 2/3 stay local
        self.axis_name = {0: Z_AXIS if self.nz > 1 else None,
                          1: T_AXIS if self.nt > 1 else None,
                          2: None, 3: None}
        self.axis_n = {0: self.nz, 1: self.nt, 2: 1, 3: 1}


def _local_D(x_local, cfg: TVConfig, ctx: _ShardCtx, global_shape):
    """D on a shard; ``global_shape`` supplies the *global* Nz/M for channel
    gating (a shard may hold 1 z-slice of a 3D volume — channels must not
    change per shard)."""
    Nz, M = global_shape[0], global_shape[1]
    chans, norm = scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    outs = []
    for ch in chans:
        d = sharded_d_channel(x_local, ch.axis, ch.kind,
                              ctx.axis_name[ch.axis], ctx.axis_n[ch.axis])
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        if w != 1.0:
            d = d * w
        outs.append(d)
    D_img = jnp.stack(outs, axis=1)
    if norm != 1.0:
        D_img = D_img * norm
    return D_img


def _local_D_T(y_local, cfg: TVConfig, ctx: _ShardCtx, global_shape):
    Nz, M = global_shape[0], global_shape[1]
    chans, norm = scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    out = None
    for i, ch in enumerate(chans):
        y = y_local[:, i]
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        if w != 1.0:
            y = y * w
        contrib = sharded_dt_channel(y, ch.axis, ch.kind,
                                     ctx.axis_name[ch.axis], ctx.axis_n[ch.axis])
        out = contrib if out is None else out + contrib
    if norm != 1.0:
        out = out * norm
    return out


def _mesh_axes(ctx: _ShardCtx):
    axes = []
    if ctx.nz > 1:
        axes.append(Z_AXIS)
    if ctx.nt > 1:
        axes.append(T_AXIS)
    return tuple(axes)


def _specs(ctx: _ShardCtx):
    t = T_AXIS if ctx.nt > 1 else None
    vol = P(Z_AXIS if ctx.nz > 1 else None, t, None, None)
    dvol = P(Z_AXIS if ctx.nz > 1 else None, None, t, None, None)
    return vol, dvol


def sharded_D(mesh: Mesh, cfg: TVConfig, global_shape, shard_time: bool = True):
    """Build ``D(x)`` running under shard_map on ``mesh``; input/output keep
    the canonical (z, t) sharding."""
    ctx = _ShardCtx(mesh, shard_time)
    vol, dvol = _specs(ctx)

    @functools.partial(shard_map, mesh=mesh, in_specs=(vol,), out_specs=dvol,
                       check_vma=False)
    def fn(x):
        return _local_D(x, cfg, ctx, global_shape)

    return jax.jit(fn)


def sharded_D_T(mesh: Mesh, cfg: TVConfig, global_shape, shard_time: bool = True):
    ctx = _ShardCtx(mesh, shard_time)
    vol, dvol = _specs(ctx)

    @functools.partial(shard_map, mesh=mesh, in_specs=(dvol,), out_specs=vol,
                       check_vma=False)
    def fn(y):
        return _local_D_T(y, cfg, ctx, global_shape)

    return jax.jit(fn)


def sharded_tv_and_subgrad(mesh: Mesh, cfg: TVConfig, global_shape,
                           shard_time: bool = True):
    """tv + subgradient under shard_map: local stencils + plane halos, tv via
    psum tree-reduction (the all-reduce analog, SURVEY.md section 2.5)."""
    ctx = _ShardCtx(mesh, shard_time)
    vol, _ = _specs(ctx)
    Nz, M = global_shape[0], global_shape[1]
    chans, norm = scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    axes = _mesh_axes(ctx)

    @functools.partial(shard_map, mesh=mesh, in_specs=(vol,),
                       out_specs=(P(), vol), check_vma=False)
    def fn(x):
        D_img = _local_D(x, cfg, ctx, global_shape)
        if cfg.norm == "aniso":
            tv = jnp.sum(jnp.abs(D_img))
            if axes:
                tv = lax.psum(tv, axes)
            # true subgradient D^T sign(D x), full weights (ops/tv.py aniso)
            G = _local_D_T(jnp.sign(D_img), cfg, ctx, global_shape)
            return tv, G
        if cfg.norm == "huber":
            norms = jnp.sqrt(jnp.sum(jnp.square(D_img), axis=1))
            d = cfg.huber_delta
            tv = jnp.sum(jnp.where(norms <= d,
                                   jnp.square(norms) / (2.0 * d),
                                   norms - d / 2.0))
            if axes:
                tv = lax.psum(tv, axes)
            # true smooth gradient D^T(D x / max(n, delta)), full weights
            G = _local_D_T(D_img / jnp.maximum(norms, d)[:, None], cfg,
                           ctx, global_shape)
            return tv, G
        norms = jnp.sqrt(jnp.sum(jnp.square(D_img), axis=1))
        tv = jnp.sum(norms)
        if axes:
            tv = lax.psum(tv, axes)
        norms = jnp.where(norms == 0, jnp.inf, norms)
        Y = D_img / norms[:, None]
        G = None
        for i, ch in enumerate(chans):
            contrib = sharded_dt_channel(Y[:, i], ch.axis, ch.kind,
                                         ctx.axis_name[ch.axis], ctx.axis_n[ch.axis])
            G = contrib if G is None else G + contrib
        if norm != 1.0:
            G = G * norm
        return tv, G

    return jax.jit(fn)


def sharded_cp_step(mesh: Mesh, cfg: TVConfig, global_shape, *, reg, sigma_D,
                    sigma_A, tau, shard_time: bool = True,
                    fidelity: str = "l2", fidelity_weight: float = 1.0,
                    nonneg: bool = False):
    """One Chambolle-Pock iteration entirely inside shard_map: the only
    communication is the 1-plane halos inside D/D_T and one scalar psum for
    the loss (``README.md:146-157`` semantics, cf. solvers/cp.py; the
    ``fidelity``/``nonneg`` family of ``cp_step`` is pointwise, so it
    shards untouched — the weight must be a replicated scalar)."""
    ctx = _ShardCtx(mesh, shard_time)
    vol, dvol = _specs(ctx)
    axes = _mesh_axes(ctx)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(vol, vol, dvol, vol), out_specs=(vol, vol, dvol, P()),
        check_vma=False,
    )
    def fn(x, y_A, y_D, x_noisy):
        from ..solvers.cp import dual_prox
        from ..solvers.fidelity import fidelity_dual_prox, fidelity_loss

        y_A = fidelity_dual_prox(y_A, x, x_noisy, sigma_A, fidelity,
                                 fidelity_weight)
        D_x = _local_D(x, cfg, ctx, global_shape)
        y_D = dual_prox(y_D + sigma_D * D_x, reg, cfg.norm, sigma_D,
                        cfg.huber_delta)
        x = x - tau * y_A - tau * _local_D_T(y_D, cfg, ctx, global_shape)
        if nonneg:
            x = jnp.maximum(x, 0.0)
        if cfg.norm == "aniso":
            tv_local = jnp.sum(jnp.abs(D_x))
        elif cfg.norm == "huber":
            n = jnp.sqrt(jnp.sum(jnp.square(D_x), axis=1))
            d = cfg.huber_delta
            tv_local = jnp.sum(jnp.where(n <= d, jnp.square(n) / (2.0 * d),
                                         n - d / 2.0))
        else:
            tv_local = jnp.sum(jnp.sqrt(jnp.sum(jnp.square(D_x), axis=1)))
        loss_local = (fidelity_loss(x, x_noisy, fidelity, fidelity_weight)
                      + reg * tv_local)
        loss = lax.psum(loss_local, axes) if axes else loss_local
        return x, y_A, y_D, loss

    return fn


def make_sharded_cp_solver(mesh: Mesh, cfg: TVConfig, global_shape, *, reg,
                           n_iter, sigma_D=0.5, sigma_A=1.0, tau=None,
                           shard_time: bool = True, fidelity: str = "l2",
                           fidelity_weight: float = 1.0,
                           nonneg: bool = False):
    """jit(lax.scan(sharded CP step)): the full multi-chip training step.
    Input arrays should be placed with ``parallel.mesh.shard_volume``."""
    from ..solvers.cp import default_tau
    from ..solvers.fidelity import validate_fidelity

    validate_fidelity(fidelity, jnp.zeros(()), fidelity_weight)
    if tau is None:
        tau = default_tau(cfg, global_shape[0], global_shape[1], sigma_A)
    step = sharded_cp_step(mesh, cfg, global_shape, reg=reg, sigma_D=sigma_D,
                           sigma_A=sigma_A, tau=tau, shard_time=shard_time,
                           fidelity=fidelity, fidelity_weight=fidelity_weight,
                           nonneg=nonneg)

    @jax.jit
    def solve(x_noisy, x, y_A, y_D):
        def body(carry, _):
            x, y_A, y_D = carry
            x, y_A, y_D, loss = step(x, y_A, y_D, x_noisy)
            return (x, y_A, y_D), loss

        (x, y_A, y_D), losses = lax.scan(body, (x, y_A, y_D), length=n_iter)
        return x, y_A, y_D, losses

    return solve
