"""Benchmark harness: solver throughput and weak-scaling measurement.

``bench.py`` at the repo root prints the single-line headline; this module is
the programmatic API (and the multi-device weak-scaling sweep, which needs
several devices or a virtual CPU mesh to be meaningful).  Every timing ends
in ``jax.block_until_ready`` of the timed call's output.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import TVConfig
from ..core.schemes import num_channels
from ..parallel import (
    d_volume_sharding,
    make_mesh,
    make_sharded_cp_solver,
    shard_volume,
)
from ..solvers.cp import chambolle_pock, init_state
from ..utils.profiling import cp_traffic_model, roofline_fraction


def bench_solver(shape=(32, 8, 256, 256), n_iter=50, repeats=3,
                 cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
                 **solver_kwargs) -> Dict[str, float]:
    """Steady-state CP throughput on the local device(s)."""
    rng = np.random.default_rng(0)
    noisy = jnp.asarray(rng.random(shape), jnp.float32)

    def run():
        res = chambolle_pock(noisy, n_iter=n_iter, reg=1.0, cfg=cfg,
                             **solver_kwargs)
        jax.block_until_ready((res.x, res.loss))
        return res

    run()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    it_s = n_iter / best
    nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    traffic = cp_traffic_model(shape, nd)
    return {
        "it_per_s": it_s,
        "gvox_it_per_s": it_s * float(np.prod(shape)) / 1e9,
        "est_gb_per_s": traffic * it_s / 1e9,
        "roofline_fraction": roofline_fraction(traffic, it_s),
    }


def _weak_scaling_sweep(make_solve_and_args, base_shape, n_iter, repeats,
                        device_counts) -> Dict[int, Dict[str, float]]:
    """Shared sweep scaffold: per-device volume held constant while z grows
    with the device count; Efficiency(n) = it/s(n) / it/s(1) — 1.0 is
    perfect weak scaling."""
    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    results: Dict[int, Dict[str, float]] = {}
    for n in device_counts:
        mesh = make_mesh(z=n, t=1, devices=devices[:n])
        shape = (base_shape[0] * n,) + tuple(base_shape[1:])
        solve, args = make_solve_and_args(mesh, shape)
        jax.block_until_ready(solve(*args))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = solve(*args)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        results[n] = {"it_per_s": n_iter / best}
    base = results[device_counts[0]]["it_per_s"]
    for n in device_counts:
        results[n]["efficiency"] = results[n]["it_per_s"] / base
    return results


def weak_scaling(base_shape=(8, 2, 128, 128), n_iter=20, repeats=3,
                 device_counts=None,
                 cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
                 ) -> Dict[int, Dict[str, float]]:
    """Weak-scaling sweep of the shard_map CP solver."""
    rng = np.random.default_rng(0)

    def build(mesh, shape):
        noisy = jnp.asarray(rng.random(shape), jnp.float32)
        solve = make_sharded_cp_solver(mesh, cfg, shape, reg=1.0,
                                       n_iter=n_iter, shard_time=False)
        st = init_state(noisy, cfg)
        args = (
            shard_volume(noisy, mesh, shard_time=False),
            shard_volume(st.x, mesh, shard_time=False),
            shard_volume(st.y_A, mesh, shard_time=False),
            jax.device_put(st.y_D, d_volume_sharding(mesh, shard_time=False)),
        )
        return solve, args

    return _weak_scaling_sweep(build, base_shape, n_iter, repeats,
                               device_counts)


def weak_scaling_tgv(base_shape=(8, 2, 128, 128), n_iter=20, repeats=3,
                     device_counts=None, axes="4d", dtype="float32",
                     alpha1=1.0, alpha0=2.0) -> Dict[int, Dict[str, float]]:
    """Weak-scaling sweep of coupled TGV-2 on a z-sharded volume (GSPMD:
    ``tgv_denoise`` on sharded input, halos inserted by XLA)."""
    from ..solvers.tgv import tgv_denoise

    rng = np.random.default_rng(0)

    def build(mesh, shape):
        x = shard_volume(jnp.asarray(rng.random(shape), dtype), mesh,
                         shard_time=False)

        def solve(x):
            return tgv_denoise(x, n_iter=n_iter, alpha1=alpha1,
                               alpha0=alpha0, axes=axes,
                               compute_loss=False).x

        return solve, (x,)

    return _weak_scaling_sweep(build, base_shape, n_iter, repeats,
                               device_counts)


def bench_ct(vol_shape=(8, 2, 256, 256), n_angles=48, n_iter=30,
             repeats=3, reg=0.5,
             cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
             seed=0, method: str = "auto") -> Dict[str, float]:
    """On-chip CT throughput: Radon forward projection, the exact adjoint,
    and the full TV-regularized ``cp_reconstruct`` loop.

    Returns projections/s for A and A_T (one projection = one (z, t, angle)
    slice line-integral set) and reconstruction it/s.

    ``method`` as in ``models.ct.make_projector``: 'auto' = the gather-free
    SPECTRAL projector on accelerators (``bench_ct_production()`` runs it
    at (16,4,512,512) x 96 angles), bilinear gather on CPU.
    """
    from ..models.ct import (
        cp_reconstruct,
        estimate_op_norm,
        make_projector,
        radon,
    )

    rng = np.random.default_rng(seed)
    Nz, M, N, _ = vol_shape
    vol = jnp.asarray(rng.random(vol_shape), jnp.float32)
    angles = jnp.asarray(np.linspace(0.0, np.pi, n_angles, endpoint=False),
                         jnp.float32)
    n_proj = Nz * M * n_angles

    A, A_T = make_projector(vol_shape, angles, method=method)
    A_j, AT_j = jax.jit(A), jax.jit(A_T)
    sino = A_j(vol)
    jax.block_until_ready(sino)

    def timed(fn, *args):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    t_A = timed(A_j, vol)
    t_AT = timed(AT_j, sino)

    # the scanned normal operator x <- x + eps A^T(A x) runs BOTH per step
    # and amortizes the per-call dispatch over the scan
    n_scan = max(30 // 2, 15)

    @jax.jit
    def normal_scan(x0):
        def body(x, _):
            return x + 1e-6 * A_T(A(x)), None

        out, _ = jax.lax.scan(body, x0, length=n_scan)
        return out

    jax.block_until_ready(normal_scan(vol))
    t_pair = timed(normal_scan, vol)

    # fix the operator norm ONCE — otherwise every timed call repeats the
    # 12-iteration power method (and each of those is ~24 projections)
    op_norm = float(estimate_op_norm(A, A_T, vol_shape))
    res = cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter, reg=reg,
                         cfg=cfg, op_norm=op_norm, method=method)
    jax.block_until_ready(res.loss)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter,
                             reg=reg, cfg=cfg, op_norm=op_norm,
                             method=method)
        jax.block_until_ready(res.loss)
        best = min(best, time.perf_counter() - t0)

    return {
        "radon_proj_per_s": n_proj / t_A,
        "radon_s": t_A,
        "adjoint_proj_per_s": n_proj / t_AT,
        "adjoint_s": t_AT,
        "normal_op_scan_it_per_s": n_scan / t_pair,
        "recon_it_per_s": n_iter / best,
        "recon_final_loss": float(res.loss[-1]),
    }


def bench_ct_production(n_iter=30, repeats=3) -> Dict[str, float]:
    """Forward + adjoint + TV-regularized ``cp_reconstruct`` at the
    PRODUCTION dynamic-CT scale ((16, 4, 512, 512) x 96 angles) on the
    gather-free spectral projector."""
    return bench_ct(vol_shape=(16, 4, 512, 512), n_angles=96,
                    n_iter=n_iter, repeats=repeats, method="spectral")


def bench_ct_cone(vol_shape=(16, 4, 512, 512), n_angles=96, n_iter=30,
                  repeats=3, reg=0.5,
                  cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
                  seed=0, source_dist_mult=2.0,
                  precision=None) -> Dict[str, float]:
    """Cone-beam CT throughput on the gather-free SSRB spectral projector:
    forward, exact adjoint, scanned normal-operator rate,
    ``cp_reconstruct(geom=cone, method='spectral')``, the rebinning FDK
    and one spectral OS-SART epoch block.  Any phase that fails raises."""
    from ..models.ct import ConeBeamGeometry, cp_reconstruct, estimate_op_norm
    from ..models.ct_spectral import make_cone_spectral_projector
    from ..utils import blob_phantom

    Nz, M, N, _ = vol_shape
    geom = ConeBeamGeometry(source_dist=source_dist_mult * N,
                            det_dist=1.0 * N)
    # blobs inside the field of view: a volume that fills the slab has
    # projections the detector's rows cut off, on which OS-SART diverges
    vol = jnp.asarray(blob_phantom(vol_shape, seed=seed))
    angles = np.linspace(0.0, 2 * np.pi, n_angles, endpoint=False)
    n_proj = M * n_angles * Nz   # one projection = one (t, angle, v) row

    A, A_T = make_cone_spectral_projector(vol_shape, angles, geom,
                                          precision=precision)
    A_j, AT_j = jax.jit(A), jax.jit(A_T)
    sino = A_j(vol)
    jax.block_until_ready(sino)

    def timed(fn, *args):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    t_A = timed(A_j, vol)
    t_AT = timed(AT_j, sino)

    n_scan = 15
    consts = A.prepare()
    op_norm = float(estimate_op_norm(A, A_T, vol_shape))

    @jax.jit
    def normal_scan(x0, c):
        def body(x, _):
            y = A.apply(c, x)
            _, vjp = jax.vjp(lambda v: A.apply(c, v), x)
            (bp,) = vjp(y)
            return x + 1e-6 * bp, None

        out, _ = jax.lax.scan(body, x0, length=n_scan)
        return out

    jax.block_until_ready(normal_scan(vol, consts))
    t_pair = timed(normal_scan, vol, consts)

    res = cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter, reg=reg,
                         cfg=cfg, geom=geom, op_norm=op_norm,
                         method="spectral", precision=precision)
    jax.block_until_ready(res.loss)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter,
                             reg=reg, cfg=cfg, geom=geom, op_norm=op_norm,
                             method="spectral", precision=precision)
        jax.block_until_ready(res.loss)
        best = min(best, time.perf_counter() - t0)

    from ..models.ct import fdk, sart

    jax.block_until_ready(fdk(sino, angles, geom, vol_shape))   # auto -> spectral
    t_fdk = timed(lambda: fdk(sino, angles, geom, vol_shape))
    jax.block_until_ready(sart(sino, angles, vol_shape, n_iter=5,
                               n_subsets=8, method="spectral", geom=geom).x)
    t_sart = timed(lambda: sart(sino, angles, vol_shape, n_iter=5,
                                n_subsets=8, method="spectral",
                                geom=geom).x)

    return {
        "cone_fwd_proj_per_s": n_proj / t_A,
        "cone_fwd_s": t_A,
        "cone_adjoint_proj_per_s": n_proj / t_AT,
        "cone_adjoint_s": t_AT,
        "cone_normal_op_scan_it_per_s": n_scan / t_pair,
        "cone_recon_it_per_s": n_iter / best,
        "cone_recon_final_loss": float(res.loss[-1]),
        "cone_fdk_s": t_fdk,
        "cone_sart_epochs_per_s": 5 / t_sart,
    }
