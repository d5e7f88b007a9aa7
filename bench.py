"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: the BASELINE.md Chambolle-Pock recipe (cameraman 256x256, reg=25,
300 iterations) as device-resident iterations/s, vs the measured reference
baseline of 208 it/s (CPU NumPy, BASELINE.md "Measured solver baselines").
Runs on a GPU only (``python bench.py``); without one it exits non-zero
before measuring anything.  Every phase that fails fails the run.

Extra diagnostics (4D throughput, bandwidth estimate) go to stderr so stdout
stays a single JSON line, which names the device it ran on.
"""

import json
import sys
import time

import numpy as np

BASELINE_CP_IT_PER_S = 300 / 1.44  # BASELINE.md: 1.44 s / 300 it, CPU


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _best_time(run, repeats):
    """Best wall time of ``run()`` over ``repeats`` calls after one warm-up
    call; each call is timed up to ``jax.block_until_ready`` of its output."""
    import jax

    jax.block_until_ready(run())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_cp_cameraman(n_iter=300, repeats=8):
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.models import add_noise
    from pytv4d_tpu.solvers.cp import chambolle_pock
    from pytv4d_tpu.utils import cameraman

    truth = cameraman().reshape((1, 1, 256, 256))
    noisy = jnp.asarray(add_noise(truth, 100.0, seed=0), dtype=jnp.float32)

    # compile + warm up
    res = chambolle_pock(noisy, n_iter=n_iter, reg=25.0)
    jax.block_until_ready(res.loss)
    final_loss = float(res.loss[-1])
    log(f"cp cameraman final loss: {final_loss:.2f} (f64 ref 38575639.48)")

    best = _best_time(lambda: chambolle_pock(noisy, n_iter=n_iter, reg=25.0),
                      repeats)
    return n_iter / best, final_loss


def bench_cp_4d(shape=(32, 8, 256, 256), n_iter=50, dual_dtype=None,
                repeats=5, primary_dtype="float32"):
    """Secondary: big-4D CP throughput + share of the device-memory
    roofline on both traffic models (two_pass = the least bytes a
    split-adjoint step must move; jnp = the unfused estimate)."""
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.core.schemes import num_channels
    from pytv4d_tpu.solvers.cp import chambolle_pock
    from pytv4d_tpu.utils.profiling import cp_traffic_model, roofline_fraction

    rng = np.random.default_rng(0)
    noisy = jnp.asarray(rng.random(shape), dtype=primary_dtype)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)

    def run():
        return chambolle_pock(noisy, n_iter=n_iter, reg=1.0, cfg=cfg,
                              dual_dtype=dual_dtype).x

    best = _best_time(run, repeats)
    vox = float(np.prod(shape))
    it_s = n_iter / best
    nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    t_min = cp_traffic_model(shape, nd, dtype=primary_dtype,
                             dual_dtype=dual_dtype)
    t_jnp = cp_traffic_model(shape, nd, dtype=primary_dtype, model="jnp",
                             dual_dtype=dual_dtype)
    frac_min = roofline_fraction(t_min, it_s)
    tag = primary_dtype if primary_dtype != "float32" else "f32"
    if dual_dtype:
        tag += f"+{dual_dtype}-dual"
    log(
        f"cp 4D {shape} {tag}: {it_s:.1f} it/s, "
        f"{vox * it_s / 1e9:.2f} Gvox-it/s, "
        f"{100 * frac_min:.0f}% of the memory roofline (two-pass model, "
        f"{t_min * it_s / 1e9:.0f} GB/s; jnp model: "
        f"{t_jnp * it_s / 1e9:.0f} GB/s = "
        f"{100 * roofline_fraction(t_jnp, it_s):.0f}%)"
    )
    return it_s, frac_min


def bench_tgv_4d(shape=(32, 8, 256, 256), n_iter=30, repeats=5,
                 axes="2d", dtype="float32", compute_loss=True):
    """Secondary: TGV-2 denoising.  Measured as the MARGINAL per-iteration
    cost via two solve lengths (n_iter and 5*n_iter), so the one-time
    per-call costs (dispatch, state allocation) do not fold into the
    rate."""
    import jax.numpy as jnp

    from pytv4d_tpu.solvers.tgv import tgv_denoise

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(shape), dtype=dtype)

    def timed(n):
        return _best_time(lambda: tgv_denoise(
            x, n_iter=n, axes=axes, compute_loss=compute_loss).x, repeats)

    it_s = (5 * n_iter - n_iter) / (timed(5 * n_iter) - timed(n_iter))
    from pytv4d_tpu.utils.profiling import roofline_fraction, tgv_traffic_model

    t_min = tgv_traffic_model(shape, axes, dtype=dtype)
    roof = (f", {100 * roofline_fraction(t_min, it_s):.0f}% of the memory "
            f"roofline (two-pass model)")
    log(f"tgv {axes} {shape} {dtype}: {it_s:.1f} it/s, "
        f"{float(np.prod(shape)) * it_s / 1e9:.2f} Gvox-it/s{roof}")
    return it_s


def bench_north_star(shape=(96, 16, 512, 512), n_iter=40, repeats=3):
    """The 403M-voxel north-star CP solve on ONE device with bf16
    primary+dual storage and ``return_dual=False``."""
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock

    rng = np.random.default_rng(0)
    noisy = jnp.asarray(rng.random(shape, dtype=np.float32), jnp.bfloat16)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)

    def run():
        return chambolle_pock(noisy, n_iter=n_iter, reg=1.0, cfg=cfg,
                              dual_dtype="bfloat16", return_dual=False).x

    it_s = n_iter / _best_time(run, repeats)
    log(f"north star {shape} bf16 p+d: {it_s:.1f} it/s, "
        f"{float(np.prod(shape)) * it_s / 1e9:.2f} Gvox-it/s")
    return it_s


def bench_ct_production_recon(n_iter=100, repeats=3, precision=None):
    """The TV-regularized ``cp_reconstruct`` at the production dynamic-CT
    scale (16, 4, 512, 512) x 96 angles on the gather-free spectral
    projector —
    reconstruction iterations/s only (the forward/adjoint breakdown lives
    in ``pytv4d_tpu.bench.harness.bench_ct_production``).  ``precision``:
    None = the library default ('highest'); 'default' = TF32 matmuls on
    the GPU (~2e-4 operator error) for the fast variant."""
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.models.ct import cp_reconstruct, make_projector
    from pytv4d_tpu.solvers.inverse import power_iteration

    vol_shape = (16, 4, 512, 512)
    n_angles = 96
    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.random(vol_shape), jnp.float32)
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)

    A, A_T = make_projector(vol_shape, angles, method="spectral",
                            precision=precision)
    sino = jax.block_until_ready(jax.jit(A)(vol))
    op_norm = float(power_iteration(A, A_T, vol_shape))

    def run():
        return cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter,
                              reg=0.5, cfg=cfg, op_norm=op_norm,
                              method="spectral", loss_every=n_iter,
                              precision=precision).x

    it_s = n_iter / _best_time(run, repeats)
    log(f"ct production recon (16,4,512,512)x96 spectral"
        f"[{precision or 'highest'}]: {it_s:.1f} it/s")
    return it_s


def main():
    from pytv4d_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {devices[0].platform!r}")
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    log(f"devices: {devices}")
    it_per_s, final_loss = bench_cp_cameraman()
    extras = {}
    it4, frac_min = bench_cp_4d()
    extras["cp_4d_it_s"] = round(it4, 1)
    extras["cp_4d_roofline_two_pass"] = round(frac_min, 3)
    it4b, _ = bench_cp_4d(dual_dtype="bfloat16", repeats=3)
    extras["cp_4d_bf16_it_s"] = round(it4b, 1)
    it4pd, _ = bench_cp_4d(dual_dtype="bfloat16", primary_dtype="bfloat16",
                           repeats=3)
    extras["cp_4d_bf16pd_it_s"] = round(it4pd, 1)
    extras["tgv_2d_it_s"] = round(bench_tgv_4d(), 1)
    extras["tgv_4d_coupled_bf16_it_s"] = round(
        bench_tgv_4d(axes="4d", dtype="bfloat16", compute_loss=False,
                     repeats=3), 1)
    extras["north_star_cp_it_s"] = round(bench_north_star(), 1)
    extras["ct_production_recon_it_s"] = round(bench_ct_production_recon(), 1)
    extras["ct_production_recon_fast_it_s"] = round(
        bench_ct_production_recon(precision="default"), 1)

    from pytv4d_tpu.bench.harness import bench_ct_cone

    cone = bench_ct_cone()
    extras["ct_cone_recon_it_s"] = round(cone["cone_recon_it_per_s"], 1)
    extras["ct_cone_fdk_s"] = round(cone["cone_fdk_s"], 3)
    extras["ct_cone_sart_epochs_s"] = round(cone["cone_sart_epochs_per_s"], 2)

    print(json.dumps({
        "metric": "cp_denoise_cameraman_300it",
        "value": round(it_per_s, 1),
        "unit": "it/s",
        "vs_baseline": round(it_per_s / BASELINE_CP_IT_PER_S, 2),
        "cp_cameraman_final_loss": final_loss,
        **extras,
        "device": device,
    }))


if __name__ == "__main__":
    main()
