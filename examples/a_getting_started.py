"""Getting started with pytv4d_tpu — the reference's
``examples/a_getting_started.ipynb`` flow, on JAX.

Covers: TV values + subgradients, GD vs Chambolle-Pock vs ADMM denoising of
the cameraman image, and the operator forms.  Runs on a GPU or the CPU.
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import numpy as np

import pytv4d_tpu as pytv
from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.models import TVDenoiser, add_noise

# ---- TV of a random 4D volume (README.md:80-92) --------------------------
np.random.seed(0)
img = np.random.rand(20, 4, 100, 100).astype(np.float32)
tv, G = pytv.tv_hybrid(img)
print(f"TV (hybrid) = {float(tv):.1f}; subgradient shape {G.shape}")

# time-coupled 4D TV: opt-in via reg_time (tv_operators_CPU.py:113)
tv_t, _ = pytv.tv_hybrid(img, reg_time=1.0)
print(f"TV with time coupling = {float(tv_t):.1f}")

# ---- Denoising (README.md:107-158) ---------------------------------------
truth = pytv.utils.cameraman()
noisy = add_noise(truth.reshape((1, 1) + truth.shape), noise_level=100, seed=0)
noisy = noisy.astype(np.float32)

model = TVDenoiser(reg=25.0, cfg=TVConfig(scheme="hybrid"))

gd = model.gd(noisy[0, 0], n_iter=300, step_size=5e-3)
print(f"subgradient descent: final loss {float(gd.loss[-1]):.1f}")

cp = model.cp(noisy[0, 0], n_iter=300)
print(f"Chambolle-Pock:      final loss {float(cp.loss[-1]):.1f}  (converges lower)")

ad = model.admm(noisy[0, 0], n_iter=60)
print(f"ADMM:                final loss {float(ad.loss[-1]):.1f}")

# ---- Operator forms for custom proximal solvers (README.md:200-222) ------
D_img = pytv.D_hybrid(img, reg_time=2 ** -5)
D_T_D = pytv.D_T_hybrid(D_img, reg_time=2 ** -5)
l21 = pytv.compute_L21_norm(D_img)
print(f"D: {D_img.shape}  D_T D: {D_T_D.shape}  L21 = {float(l21):.1f}")

# ---- Differentiable TV for optax-style optimizers ------------------------
import jax

tv_fn = pytv.make_tv("hybrid", reg_time=0.5)
grad = jax.grad(tv_fn)(np.asarray(img))
print(f"jax.grad of TV matches the subgradient convention; |grad| = "
      f"{float(abs(grad).sum()):.1f}")

# ---- Beyond the reference (docs/solvers.md is the full picker) ------------
# robust + certified: TV-L1 fidelity for impulsive noise, nonnegativity,
# and a duality-gap certificate instead of a loss-delta heuristic
cp_l1 = model.cp(noisy[0, 0], n_iter=100, fidelity="l1",
                 fidelity_weight=0.02, nonneg=True)
from pytv4d_tpu.solvers import pd_gap

gap = float(pd_gap(cp.state, noisy, reg=25.0))  # state keeps the 4D layout
print(f"TV-L1 denoise loss {float(cp_l1.loss[-1]):.1f}; l2 solve duality "
      f"gap {gap:.2e} (certified suboptimality bound)")

# staircasing-free second-order TGV on the same image
tgv = model.tgv(noisy[0, 0], n_iter=100)
print(f"TGV-2:               final loss {float(tgv.loss[-1]):.1f}")
