"""What XLA makes of the plain jax.numpy denoising steps on the GPU.

    python tools/measure_xla_steps.py [--shape 32 8 256 256] [--out FILE]

For the CP step (hybrid scheme with time coupling: Nd = 8 channels, f32)
and the coupled TGV-2 ('4d') step it reports, on the first GPU:

- the marginal device time per iteration (two scan lengths, each timed
  up to ``jax.block_until_ready``; compile excluded),
- the bytes XLA's cost model says one compiled step accesses
  (``compiled.cost_analysis()["bytes accessed"]``), in volume-equivalents,
  beside the two-pass byte models of ``utils.profiling``,
- the achieved bandwidth as a share of the card's published peak and of
  a large device-to-device copy timed in the same process.

Prints one JSON line (also written to ``--out`` when given).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _best(fn, repeats=5):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _marginal(run, n1, n2):
    """Per-iteration time from two solve lengths (one-time costs cancel)."""
    return (_best(lambda: run(n2)) - _best(lambda: run(n1))) / (n2 - n1)


def _bytes(compiled) -> float:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["bytes accessed"])


def copy_bandwidth(n_bytes=4 * 2**30):
    """GB/s of a large device-to-device copy (read + write)."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((n_bytes // 4,), jnp.float32)
    copy = jax.jit(lambda v: v * 1.0)
    return 2 * n_bytes / _best(lambda: copy(a)) / 1e9


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=4, default=(32, 8, 256, 256))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from pytv4d_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.core.schemes import num_channels
    from pytv4d_tpu.solvers.cp import CPState, chambolle_pock, cp_step, \
        default_tau, init_state
    from pytv4d_tpu.solvers.tgv import _tgv_denoise_impl, tgv_denoise
    from pytv4d_tpu.utils.profiling import (
        cp_traffic_model,
        device_peaks,
        tgv_traffic_model,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    shape = tuple(args.shape)
    vox_bytes = float(np.prod(shape)) * 4
    peak = device_peaks(dev.device_kind)["hbm_gbps"]
    copy_gbps = copy_bandwidth()
    out = {"card": card, "device_kind": dev.device_kind, "shape": shape,
           "copy_gbps": copy_gbps, "peak_gbps": peak}

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    x0 = jax.random.uniform(jax.random.key(0), shape, jnp.float32) * 100
    tau = default_tau(cfg, shape[0], shape[1])

    def step(st, x0):
        return cp_step(CPState(*st), x0, reg=5.0, sigma_D=0.5, sigma_A=1.0,
                       tau=tau, cfg=cfg)

    st = tuple(init_state(x0, cfg))
    cp_bytes = _bytes(jax.jit(step).lower(st, x0).compile())
    t_cp = _marginal(lambda n: chambolle_pock(x0, n_iter=n, reg=5.0,
                                              cfg=cfg).x, 10, 60)
    out["cp"] = {
        "Nd": nd, "s_per_it": t_cp,
        "xla_bytes": cp_bytes, "xla_vol_eq": cp_bytes / vox_bytes,
        "model_two_pass_vol_eq": cp_traffic_model(shape, nd) / vox_bytes,
        "model_jnp_vol_eq": cp_traffic_model(shape, nd, model="jnp")
        / vox_bytes,
        "gbps": cp_bytes / t_cp / 1e9,
    }

    t_tgv = _marginal(lambda n: tgv_denoise(
        x0, n_iter=n, alpha1=0.1, alpha0=0.2, axes="4d",
        compute_loss=False).x, 10, 40)
    tgv_state = tuple(tgv_denoise(x0, n_iter=1, alpha1=0.1, alpha0=0.2,
                                  axes="4d", compute_loss=False).state)
    tgv_bytes = _bytes(_tgv_denoise_impl.lower(
        x0, tgv_state, n_iter=1, alpha1=0.1, alpha0=0.2, sigma_tau_split=1.0,
        axes="4d", compute_loss=False, loss_every=0).compile())
    out["tgv4d"] = {
        "s_per_it": t_tgv,
        "xla_bytes": tgv_bytes, "xla_vol_eq": tgv_bytes / vox_bytes,
        "model_two_pass_vol_eq": tgv_traffic_model(shape, "4d") / vox_bytes,
        "gbps": tgv_bytes / t_tgv / 1e9,
    }
    for k in ("cp", "tgv4d"):
        out[k]["share_of_peak"] = out[k]["gbps"] / peak
        out[k]["share_of_copy"] = out[k]["gbps"] / copy_gbps
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
