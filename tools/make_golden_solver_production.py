"""Production-scale reference-parity golden: run the
REFERENCE CPU Chambolle-Pock denoising recipe (README.md:139-158, with
the keepdims fix the 4D case requires — SURVEY.md 2.4.6) in f64 at the
largest reference-runnable scale here, (16, 4, 512, 512) with time
coupling, and record the loss trajectory plus final-x probes.

Writes tests/golden/golden_solver4d_production.npz.  ~10 min of numpy on
this host; run once (the fixture is committed).  The companion test
(tests/test_golden.py::test_production_scale_cp_parity, full tier)
replays our solver against it; the on-chip spot check lives in
tools/bench_golden_production.py.
"""

import os
import sys
import time

import numpy as np

REF = os.environ.get("PYTV_REFERENCE", "/root/reference")
OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                   "golden_solver4d_production.npz")
sys.path.insert(0, REF)
import pytv  # noqa: E402

SHAPE = (16, 4, 512, 512)
REG = 5.0
REG_TIME = 0.5
N_IT = 50

rng = np.random.default_rng(20260819)
noisy = rng.random(SHAPE) * 100.0

sigma_D, sigma_A = 0.5, 1.0
L2 = 0.5 * (4 * 4.0 + 4 * 2.0 * REG_TIME)   # ||D||^2 bound, hybrid z+t
tau = 1.0 / (L2 + sigma_A)

x = np.copy(noisy)
yA = np.zeros_like(x)
yD = np.zeros_like(pytv.tv_operators_CPU.D_hybrid(x, reg_time=REG_TIME))
losses = []
t0 = time.time()
for it in range(N_IT):
    yA = (yA + sigma_A * (x - noisy)) / (1.0 + sigma_A)
    D_x = pytv.tv_operators_CPU.D_hybrid(x, reg_time=REG_TIME)
    p = yD + sigma_D * D_x
    n = np.sqrt(np.sum(p ** 2, axis=1, keepdims=True))
    yD = p / np.maximum(1.0, n / REG)
    x = x - tau * yA - tau * pytv.tv_operators_CPU.D_T_hybrid(
        yD, reg_time=REG_TIME)
    losses.append(0.5 * np.sum(np.square(x - noisy))
                  + REG * pytv.tv_operators_CPU.compute_L21_norm(D_x))
    if it % 5 == 0:
        print(f"it {it}: loss {losses[-1]:.6f} "
              f"({time.time() - t0:.0f}s)", flush=True)

# final-x probes: a strided subsample (full x is 134 MB f64) + moments
probe = x[::4, :, ::16, ::16]
np.savez_compressed(
    OUT,
    seed=20260819, shape=np.asarray(SHAPE), reg=REG, reg_time=REG_TIME,
    tau=tau, losses=np.asarray(losses),
    x_probe=probe, x_mean=np.mean(x), x_l2=np.linalg.norm(x.ravel()),
)
print("wrote", os.path.abspath(OUT), "final loss", losses[-1],
      f"({time.time() - t0:.0f}s total)")
