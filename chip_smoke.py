"""On-device smoke test of the package's main paths on one GPU.

    python chip_smoke.py          # every single-GPU phase at full size
    python chip_smoke.py --four   # only the four-GPU sharded phase

Each phase drives a public entry point at the size its users run, checks
the result against the repository's plain references (the recorded
upstream float64 values, the NumPy recipes in ``pytv4d_tpu.reference``,
``precision='highest'`` projectors, the CPU backend) and prints one line:
name, size, steady-state time, compile time, measured error and its bound.
Any failed check raises, so the script exits non-zero.  Without a GPU it
exits non-zero before running anything.  The last line of stdout is the
JSON device record.

Every phase function takes its size as arguments, so the CPU tests can
rehearse it at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TV_GOLDEN = 532166.8251801673            # tv_hybrid(rand(20,4,100,100)), f64
TV_GOLDEN_SHAPE = (20, 4, 100, 100)
CP_CAMERAMAN_GOLDEN = 38575639.48          # README CP recipe, 300 it, f64
GD_CAMERAMAN_GOLDEN = 39074939.78          # README GD recipe, 300 it, f64
PRODUCTION_GOLDEN = os.path.join(HERE, "tests", "golden",
                                 "golden_solver4d_production.npz")


class PhaseFailed(AssertionError):
    pass


def line(name, size, seconds, compile_s, err, bound, note=""):
    """Print one phase line; raise when ``err`` is not within ``bound``."""
    ok = bool(np.isfinite(err)) and err <= bound
    print(f"{name:<24} size={size:<26} time={seconds:.6f}s "
          f"compile={compile_s:.3f}s err={err:.3e} bound={bound:.1e} "
          f"{'ok' if ok else 'FAIL'} {note}".rstrip(), flush=True)
    if not ok:
        raise PhaseFailed(f"{name}: error {err:.3e} exceeds {bound:.1e}")


def timed(fn, repeats=1):
    """``(result, first_call_s, steady_s)``: the first call includes the
    compile; the steady time is the best of ``repeats`` later calls, each
    up to ``jax.block_until_ready`` of its result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def shape_str(shape, extra=""):
    return "x".join(str(s) for s in shape) + extra


# --------------------------------------------------------------------------
# single-GPU phases
# --------------------------------------------------------------------------


def phase_tv(shape=TV_GOLDEN_SHAPE):
    """TV value and subgradient (``tv_hybrid``) and ``D``/``D_T`` of all
    four schemes on the device in f32, against the NumPy f64 path."""
    import jax.numpy as jnp

    import pytv4d_tpu as pytv

    np.random.seed(0)
    img = np.random.rand(*shape)
    tv_ref, G_ref = pytv.tv_CPU.tv_hybrid(img)
    if tuple(shape) == TV_GOLDEN_SHAPE:
        # NumPy's summation order may move the last ulp
        assert abs(float(tv_ref) - TV_GOLDEN) <= 1e-12 * TV_GOLDEN, tv_ref
    x = jnp.asarray(img, jnp.float32)
    (tv, G), first, steady = timed(lambda: pytv.tv_hybrid(x))
    line("tv_hybrid value", shape_str(shape), steady, first - steady,
         abs(float(tv) - tv_ref) / tv_ref, 1e-4,
         f"tv={float(tv):.6f} ref={float(tv_ref):.10f}")
    line("tv_hybrid subgradient", shape_str(shape), steady, first - steady,
         rel(G, G_ref), 1e-4)

    rng = np.random.default_rng(1)
    worst_adj = worst_np = 0.0
    t_pair = 0.0
    for scheme in ("upwind", "downwind", "central", "hybrid"):
        D = getattr(pytv, f"D_{scheme}")
        D_T = getattr(pytv, f"D_T_{scheme}")
        Dx, first, steady = timed(lambda: D(x, reg_time=0.5))
        y = jnp.asarray(rng.standard_normal(Dx.shape), jnp.float32)
        DTy, _, steady_t = timed(lambda: D_T(y, reg_time=0.5))
        t_pair = max(t_pair, steady + steady_t)
        lhs = float(jnp.vdot(Dx, y))
        rhs = float(jnp.vdot(x, DTy))
        worst_adj = max(worst_adj, abs(lhs - rhs) / max(abs(lhs), 1e-30))
        D_np = getattr(pytv.tv_operators_CPU, f"D_{scheme}")
        worst_np = max(worst_np, rel(Dx, D_np(img, reg_time=0.5)))
    line("D/D_T adjointness", shape_str(shape, " 4 schemes"), t_pair, 0.0,
         worst_adj, 1e-5)
    line("D vs NumPy f64", shape_str(shape, " 4 schemes"), t_pair, 0.0,
         worst_np, 1e-6)


def phase_denoise(size=256, n_iter=300):
    """The README cameraman recipes through ``TVDenoiser``: CP and GD at
    reg=25, against the recorded upstream f64 losses at 256 x 256 and 300
    iterations, and against the NumPy f64 recipes at other sizes."""
    import jax.numpy as jnp

    from pytv4d_tpu import reference
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models import TVDenoiser, add_noise
    from pytv4d_tpu.utils import cameraman

    noisy = add_noise(cameraman()[:size, :size].reshape((1, 1, size, size)),
                      100.0, seed=0)
    golden = size == 256 and n_iter == 300
    if golden:
        cp_ref, gd_ref = CP_CAMERAMAN_GOLDEN, GD_CAMERAMAN_GOLDEN
    else:
        cfg = TVConfig()
        cp_ref = reference.chambolle_pock(noisy, n_iter, 25.0, cfg)[1][-1]
        gd_ref = reference.subgradient_descent(noisy, n_iter, 25.0, 5e-3,
                                               cfg)[1][-1]
    model = TVDenoiser(reg=25.0)
    x = jnp.asarray(noisy[0, 0], jnp.float32)
    res, first, steady = timed(lambda: model.cp(x, n_iter=n_iter), 3)
    loss = float(res.loss[-1])
    line("cameraman CP", f"{size}x{size} {n_iter}it", steady,
         first - steady, abs(loss - cp_ref) / cp_ref, 1e-5,
         f"loss={loss:.2f} ref={cp_ref:.2f} {n_iter / steady:.0f} it/s")
    res, first, steady = timed(lambda: model.gd(x, n_iter=n_iter), 3)
    loss = float(res.loss[-1])
    line("cameraman GD", f"{size}x{size} {n_iter}it", steady,
         first - steady, abs(loss - gd_ref) / gd_ref, 1e-4,
         f"loss={loss:.2f} ref={gd_ref:.2f} {n_iter / steady:.0f} it/s")


def phase_cp4d(shape=(16, 4, 512, 512), n_iter=50):
    """``chambolle_pock`` at the production 4D width in f32 and with bf16
    duals, against the upstream f64 loss trajectory recorded at
    (16,4,512,512) (the NumPy f64 recipe at other shapes)."""
    import jax.numpy as jnp

    from pytv4d_tpu import reference
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock

    g = np.load(PRODUCTION_GOLDEN)
    cfg = TVConfig(scheme="hybrid", reg_time=float(g["reg_time"]))
    reg, tau = float(g["reg"]), float(g["tau"])
    noisy = np.random.default_rng(int(g["seed"])).random(shape) * 100.0
    if tuple(shape) == tuple(g["shape"]) and n_iter == len(g["losses"]):
        want = g["losses"]
    else:
        want = reference.chambolle_pock(noisy, n_iter, reg, cfg, tau=tau)[1]
    x = jnp.asarray(noisy, jnp.float32)
    for dual in (None, "bfloat16"):
        res, first, steady = timed(lambda: chambolle_pock(
            x, n_iter=n_iter, reg=reg, cfg=cfg, tau=tau, dual_dtype=dual))
        err = float(np.max(np.abs(np.asarray(res.loss, np.float64) - want)
                           / want))
        line(f"cp4d golden {dual or 'f32'}", shape_str(shape, f" {n_iter}it"),
             steady, first - steady, err, 1e-4,
             f"{n_iter / steady:.1f} it/s")


def phase_north_star(shape=(96, 16, 512, 512), n_iter=5):
    """The north-star volume on one device: bf16 primary and dual storage,
    ``return_dual=False``.  Checks a finite, decreasing loss and prints the
    compiled step's memory analysis and the device's peak memory."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x = (jax.random.uniform(jax.random.key(0), shape, jnp.float32)
         * 100.0).astype(jnp.bfloat16)
    kw = dict(n_iter=n_iter, reg=5.0, cfg=cfg, dual_dtype="bfloat16",
              return_dual=False)
    t0 = time.perf_counter()
    mem = chambolle_pock._jit.lower(x, **kw).compile().memory_analysis()
    compile_s = time.perf_counter() - t0
    print(f"north star memory_analysis: {mem}", flush=True)
    # the jitted call below finds the program in the persistent cache
    res, first, steady = timed(lambda: chambolle_pock(x, **kw))
    loss = np.asarray(res.loss, np.float64)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", float("nan"))
    print(f"north star peak_bytes_in_use: {peak}", flush=True)
    finite = bool(np.all(np.isfinite(loss)))
    line("north star bf16 p+d", shape_str(shape, f" {n_iter}it"), steady,
         compile_s, 0.0 if finite and loss[-1] < loss[0] else 1.0, 0.0,
         f"loss {loss[0]:.6e} -> {loss[-1]:.6e} "
         f"{n_iter / steady:.2f} it/s peak={peak / 2**30:.2f} GiB")


def phase_tgv(shape=(32, 8, 256, 256), n_iter=20, small=(4, 4, 64, 64)):
    """``tgv_denoise`` in-plane ('2d') and coupled space-time ('4d'):
    finite, decreasing loss at full size, and the same solve at a small
    size on the device against the CPU backend in the same process."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.solvers.tgv import tgv_denoise

    x = jnp.asarray(np.random.default_rng(2).random(shape), jnp.float32)
    xs = np.random.default_rng(3).random(small).astype(np.float32)
    cpu = jax.devices("cpu")[0]
    for axes in ("2d", "4d"):
        kw = dict(n_iter=n_iter, alpha1=0.1, alpha0=0.2, axes=axes)
        res, first, steady = timed(lambda: tgv_denoise(x, **kw))
        loss = np.asarray(res.loss, np.float64)
        ok = bool(np.all(np.isfinite(loss))) and loss[-1] < loss[0]
        line(f"tgv {axes}", shape_str(shape, f" {n_iter}it"), steady,
             first - steady, 0.0 if ok else 1.0, 0.0,
             f"loss {loss[0]:.6e} -> {loss[-1]:.6e} "
             f"{n_iter / steady:.1f} it/s")
        dev = tgv_denoise(jnp.asarray(xs), **kw)
        with jax.default_device(cpu):
            host = tgv_denoise(jax.device_put(xs, cpu), **kw)
        err = max(rel(dev.x, host.x), rel(dev.loss, host.loss))
        line(f"tgv {axes} device vs cpu", shape_str(small, f" {n_iter}it"),
             0.0, 0.0, err, 1e-5)


def _phantom(vol_shape):
    """A (Nz, M, N, N) attenuation phantom in [0.03, 1]: the synthetic
    ellipse image, scaled per frame so the time axis carries signal."""
    from pytv4d_tpu.utils import synthetic_phantom

    Nz, M, N, _ = vol_shape
    img = synthetic_phantom(N).astype(np.float32) / 255.0
    scale = 1.0 + 0.05 * np.arange(M, dtype=np.float32)
    return np.broadcast_to(img * scale[:, None, None],
                           vol_shape).astype(np.float32)


# documented accuracy of each spectral projector rung against 'highest'
# (ct_spectral._DEFAULT_PRECISION); the check allows 10x
RUNG_ACCURACY = {"highest": 0.0, "high": 2.3e-4, "default": 2.3e-4}
CONE_HIGH_ACCURACY = 3.5e-4


def phase_ct_parallel(vol_shape=(16, 4, 512, 512), n_angles=96, n_iter=30):
    """Dynamic parallel-beam CT on the spectral projector: each matmul
    precision rung of A and A^T against ``precision='highest'``, a
    30-iteration ``cp_reconstruct`` scored against the phantom, and the
    same solve with a bf16 TV dual against the f32 one."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import cp_reconstruct, make_projector

    truth = jnp.asarray(_phantom(vol_shape))
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    size = shape_str(vol_shape, f" x{n_angles}")

    def pair(precision):
        A, A_T = make_projector(vol_shape, angles, method="spectral",
                                precision=precision)
        fA, fAT = jax.jit(A), jax.jit(A_T)
        sino, first_a, steady_a = timed(lambda: fA(truth), 2)
        bp, first_t, steady_t = timed(lambda: fAT(sino), 2)
        return sino, bp, first_a + first_t - steady_a - steady_t, \
            steady_a + steady_t

    sino_hi, bp_hi, comp, t_hi = pair("highest")
    line("ct rung highest", size, t_hi, comp, 0.0, 0.0, "A+A^T pair")
    for rung in ("high", "default"):
        sino, bp, comp, t = pair(rung)
        err = max(rel(sino, sino_hi), rel(bp, bp_hi))
        line(f"ct rung {rung}", size, t, comp, err,
             10 * RUNG_ACCURACY[rung], "A+A^T pair")

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    res, first, steady = timed(lambda: cp_reconstruct(
        sino_hi, angles, vol_shape, n_iter=n_iter, reg=0.05, cfg=cfg,
        method="spectral"))
    loss = np.asarray(res.loss, np.float64)
    assert np.all(np.isfinite(loss)) and loss[-1] < loss[0], loss
    line("ct parallel recon", size + f" {n_iter}it", steady, first - steady,
         rel(res.x, truth), 0.15,
         f"{n_iter / steady:.1f} it/s (incl. power method)")
    res_b, first, steady = timed(lambda: cp_reconstruct(
        sino_hi, angles, vol_shape, n_iter=n_iter, reg=0.05, cfg=cfg,
        method="spectral", dual_dtype="bfloat16"))
    line("ct recon bf16 dual", size + f" {n_iter}it", steady, first - steady,
         rel(res_b.x, res.x), 2e-3,
         f"vs the f32 solve; {n_iter / steady:.1f} it/s (incl. power method)")


def phase_ct_cone(vol_shape=(16, 4, 512, 512), n_angles=96, n_iter=30,
                  small=(16, 1, 64, 64)):
    """Cone-beam CT (the ``bench_ct_cone`` geometry, source at 2N, detector
    at N, as many detector rows as slices) on a blob phantom that lies
    inside the beam's field of view: the spectral cone projector at the
    default rung ('highest') and at 'high'; ``fdk``; ``cp_reconstruct``
    warm-started from the FDK; ``sart`` at its default ``relax``; each
    scored against the phantom.  FDK also runs at a small size on the
    device against the CPU backend in the same process.

    Bounds sit between a sound reading and a broken one (CPU at N=64/128:
    FDK 0.036, the same FDK at half amplitude 0.50; 30 CP iterations
    warm-started from it 0.017, cold-started 0.25; 5 SART epochs 0.084,
    at relax=0.25 0.35)."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models import ct_spectral as cs
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        cp_reconstruct,
        fdk,
        sart,
    )
    from pytv4d_tpu.utils import blob_phantom

    N = vol_shape[-1]
    geom = ConeBeamGeometry(source_dist=2.0 * N, det_dist=1.0 * N)
    truth = jnp.asarray(blob_phantom(vol_shape))
    angles = np.linspace(0.0, 2 * np.pi, n_angles, endpoint=False)
    size = shape_str(vol_shape, f" x{n_angles}")

    A, _ = cs.make_cone_spectral_projector(vol_shape, angles, geom)
    sino, first, steady = timed(lambda: jax.jit(A)(truth), 2)
    line(f"cone A {cs._DEFAULT_PRECISION} (default)", size, steady,
         first - steady, 0.0, 0.0)
    A_hi, _ = cs.make_cone_spectral_projector(vol_shape, angles, geom,
                                              precision="high")
    sino_hi, first, steady = timed(lambda: jax.jit(A_hi)(truth), 2)
    line("cone A high", size, steady, first - steady, rel(sino_hi, sino),
         10 * CONE_HIGH_ACCURACY)

    x_fdk, first, steady = timed(lambda: fdk(sino, angles, geom, vol_shape,
                                             method="spectral"))
    line("cone fdk", size, steady, first - steady, rel(x_fdk, truth), 0.15,
         f"half amplitude would read {rel(0.5 * x_fdk, truth):.3f}")
    geom_s = ConeBeamGeometry(source_dist=2.0 * small[-1],
                              det_dist=1.0 * small[-1])
    A_s, _ = cs.make_cone_spectral_projector(small, angles, geom_s)
    sino_s = np.asarray(jax.jit(A_s)(jnp.asarray(blob_phantom(small))))
    dev = fdk(jnp.asarray(sino_s), angles, geom_s, small, method="spectral")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        host = fdk(jax.device_put(sino_s, cpu), angles, geom_s, small,
                   method="spectral")
    line("cone fdk device vs cpu", shape_str(small, f" x{n_angles}"), 0.0,
         0.0, rel(dev, host), 1e-4)

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    res, first, steady = timed(lambda: cp_reconstruct(
        sino, angles, vol_shape, n_iter=n_iter, reg=0.05, cfg=cfg, geom=geom,
        x_init=x_fdk, method="spectral"))
    loss = np.asarray(res.loss, np.float64)
    assert np.all(np.isfinite(loss)) and loss[-1] < loss[0], loss
    # the solve must improve on its warm start by a quarter at least
    line("cone recon from fdk", size + f" {n_iter}it", steady,
         first - steady, rel(res.x, truth), 0.75 * rel(x_fdk, truth),
         f"{n_iter / steady:.1f} it/s (incl. power method)")

    res, first, steady = timed(lambda: sart(
        sino, angles, vol_shape, n_iter=5, n_subsets=8, method="spectral",
        geom=geom))
    resid = np.asarray(res.residual)
    assert resid[-1] < resid[0], resid
    line("cone sart", size + " 5 epochs", steady, first - steady,
         rel(res.x, truth), 0.15, f"{5 / steady:.2f} epochs/s")


# --------------------------------------------------------------------------
# four-GPU phase
# --------------------------------------------------------------------------


def phase_four(shape=(32, 8, 256, 256), n_iter=20,
               ct_shape=(16, 4, 512, 512), n_angles=96, ct_iter=30):
    """(z, t) sharding on four devices, taken from ``jax.devices()`` in
    order: the shard_map CP solver on a (4, 1) and a (2, 2) mesh, and the
    spectral ``cp_reconstruct`` on a z-sharded sinogram — each against the
    same solve on one device, and each timed."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import (
        cp_reconstruct,
        estimate_op_norm,
        make_projector,
        sinogram_sharding,
    )
    from pytv4d_tpu.parallel import (
        d_volume_sharding,
        make_mesh,
        make_sharded_cp_solver,
        shard_volume,
    )
    from pytv4d_tpu.solvers.cp import chambolle_pock, init_state

    devices = jax.devices()[:4]
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(5).random(shape) * 100.0,
                        jnp.float32)
    one, first, steady1 = timed(lambda: chambolle_pock(
        noisy, n_iter=n_iter, reg=5.0, cfg=cfg), 2)
    line("cp 1 device", shape_str(shape, f" {n_iter}it"), steady1,
         first - steady1, 0.0, 0.0, f"{n_iter / steady1:.1f} it/s")
    st = init_state(noisy, cfg)
    for z, t in ((4, 1), (2, 2)):
        mesh = make_mesh(z=z, t=t, devices=devices)
        solve = make_sharded_cp_solver(mesh, cfg, shape, reg=5.0,
                                       n_iter=n_iter)
        args = (shard_volume(noisy, mesh), shard_volume(st.x, mesh),
                shard_volume(st.y_A, mesh),
                jax.device_put(st.y_D, d_volume_sharding(mesh)))
        (x, _, _, losses), first, steady = timed(lambda: solve(*args), 2)
        err = max(rel(x, one.x), float(np.max(np.abs(
            np.asarray(losses) - np.asarray(one.loss))
            / np.asarray(one.loss))))
        line(f"cp shard_map z{z} t{t}", shape_str(shape, f" {n_iter}it"),
             steady, first - steady, err, 1e-5,
             f"{n_iter / steady:.1f} it/s, {steady1 / steady:.2f}x")

    truth = jnp.asarray(_phantom(ct_shape))
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    A, A_T = make_projector(ct_shape, angles, method="spectral")
    sino = jax.jit(A)(truth)
    op_norm = float(estimate_op_norm(A, A_T, ct_shape))
    kw = dict(n_iter=ct_iter, reg=0.05, cfg=cfg, op_norm=op_norm,
              method="spectral")
    size = shape_str(ct_shape, f" x{n_angles} {ct_iter}it")
    ref, first, steady1 = timed(lambda: cp_reconstruct(
        sino, angles, ct_shape, **kw))
    line("ct recon 1 device", size, steady1, first - steady1,
         rel(ref.x, truth), 0.15, f"{ct_iter / steady1:.1f} it/s")
    mesh = make_mesh(z=4, t=1, devices=devices)
    sino_sh = jax.device_put(sino, sinogram_sharding(mesh))
    res, first, steady = timed(lambda: cp_reconstruct(
        sino_sh, angles, ct_shape, **kw))
    assert len(res.x.sharding.device_set) == 4
    line("ct recon z4 sharded", size, steady, first - steady,
         rel(res.x, ref.x), 1e-4,
         f"{ct_iter / steady:.1f} it/s, {steady1 / steady:.2f}x")


SINGLE_PHASES = (phase_tv, phase_denoise, phase_cp4d, phase_north_star,
                 phase_tgv, phase_ct_parallel, phase_ct_cone)


def card_record() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU sharded phase")
    args = parser.parse_args(argv)

    from pytv4d_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found "
              f"{devices[0].platform!r} devices", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke.py needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    print(card_record(), flush=True)   # name, power limit: one line per card
    print(f"devices: {len(devices)} x {devices[0].device_kind}", flush=True)

    t0 = time.perf_counter()
    for phase in ((phase_four,) if args.four else SINGLE_PHASES):
        phase()
    print(f"total: {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
