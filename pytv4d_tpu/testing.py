"""Package-level test battery — parity with ``pytv.run_CPU_tests`` /
``pytv.run_GPU_tests`` (``pytv/tests.py:48-86``, exported at package level by
``pytv/__init__.py:57,60``).

Implements the reference's four correctness oracles (SURVEY.md section 4) with
the reference's defects fixed: direct function references instead of ``eval``
string dispatch (``tests.py:122``), seeded rngs instead of the admitted
flakiness (``README.md:61``), and no ragged ``np.mean`` crash
(``tests.py:105,226``).
"""

from __future__ import annotations

import numpy as np

from . import tv_CPU, tv_GPU, tv_operators_CPU, tv_operators_GPU

_SCHEMES = ("upwind", "downwind", "hybrid", "central")


def _backend(name):
    if name == "cpu":
        return tv_operators_CPU, tv_CPU
    return tv_operators_GPU, tv_GPU


def test_equal(arr1, arr2, tol=1e-5, name=""):
    """Relative allclose comparator (``pytv/tests.py:88-109``): max abs
    difference over the mean magnitude must be below ``tol``."""
    a = np.asarray(arr1, dtype=np.float64)
    b = np.asarray(arr2, dtype=np.float64)
    scale = 0.5 * (np.mean(np.abs(a)) + np.mean(np.abs(b)))
    if scale == 0:
        err = np.max(np.abs(a - b)) if a.size else 0.0
    else:
        err = np.max(np.abs(a - b)) / scale
    assert err < tol, f"{name}: relative error {err:.3e} >= tol {tol:.1e}"
    return err


def test_transpose(D_fn, D_T_fn, img_shape, Nd, n=10, tol=1e-4, seed=0):
    """Numeric adjointness oracle (``pytv/tests.py:363-404``): over ``n``
    seeded random draws, |<Y, D X> - <D^T Y, X>| relative mismatch < tol."""
    rng = np.random.default_rng(seed)
    Nz, M, Nr, Nc = img_shape
    for _ in range(n):
        X = rng.random(img_shape)
        Y = rng.random((Nz, Nd, M, Nr, Nc))
        DX = np.asarray(D_fn(X))
        DTY = np.asarray(D_T_fn(Y))
        lhs = np.sum(Y * DX)
        rhs = np.sum(DTY * X)
        denom = 0.5 * (abs(lhs) + abs(rhs))
        assert denom > 0 and abs(lhs - rhs) / denom < tol, (
            f"adjointness violated: <Y,DX>={lhs!r} vs <D^T Y,X>={rhs!r}"
        )


def test_operator_transpose(scheme, backend="cpu", tol=1e-4):
    """Adjointness across 2D/3D/4D, reg_z in {1, 0}, M in {2, 3, 4}
    (``pytv/tests.py:111-185``)."""
    ops_mod, _ = _backend(backend)
    D_fn_base = getattr(ops_mod, f"D_{scheme}")
    D_T_fn_base = getattr(ops_mod, f"D_T_{scheme}")
    N = 16
    cases = []
    for reg_z in (1.0, 0.0):
        cases.append(dict(shape=(1, 1, N, N), reg_z=reg_z, reg_t=0.0))  # 2D
        cases.append(dict(shape=(6, 1, N, N), reg_z=reg_z, reg_t=0.0))  # 3D
        for M in (2, 3, 4):
            cases.append(dict(shape=(6, M, N, N), reg_z=reg_z, reg_t=0.5))  # 4D
    for i, case in enumerate(cases):
        Nz, M = case["shape"][0], case["shape"][1]
        from .core.schemes import num_channels

        Nd = num_channels(scheme, Nz, M, case["reg_z"], case["reg_t"])

        def D_fn(img):
            return D_fn_base(img, reg_z_over_reg=case["reg_z"], reg_time=case["reg_t"])

        def D_T_fn(y):
            return D_T_fn_base(y, reg_z_over_reg=case["reg_z"], reg_time=case["reg_t"])

        test_transpose(D_fn, D_T_fn, case["shape"], Nd, n=4, tol=tol, seed=100 + i)
    print(f"\t[PASS] D_{scheme} / D_T_{scheme} adjointness ({backend})")


def test_2D_to_3D(scheme, backend="cpu", tol=1e-5):
    """Dimensional-consistency oracle (``pytv/tests.py:187-245``): tiling a 2D
    image Nz times scales the TV by Nz (with reg_z=0) and the middle slice of
    G / D / D^T D equals the 2D result."""
    ops_mod, tv_mod = _backend(backend)
    rng = np.random.default_rng(7)
    N, Nz = 20, 5
    img2d = rng.random((1, 1, N, N))
    img3d = np.broadcast_to(img2d[0], (Nz, 1, N, N)).copy()
    tv_fn = getattr(tv_mod, f"tv_{scheme}")
    D_fn = getattr(ops_mod, f"D_{scheme}")
    D_T_fn = getattr(ops_mod, f"D_T_{scheme}")

    tv2, G2 = tv_fn(img2d)
    tv3, G3 = tv_fn(img3d, reg_z_over_reg=0.0)
    assert abs(float(tv3) - Nz * float(tv2)) / float(tv3) < tol
    test_equal(np.asarray(G3)[Nz // 2], np.asarray(G2)[0], tol, "G mid-slice")

    D2 = np.asarray(D_fn(img2d))
    D3 = np.asarray(D_fn(img3d, reg_z_over_reg=0.0))
    test_equal(D3[Nz // 2], D2[0], tol, "D mid-slice")
    DT2 = np.asarray(D_T_fn(D2))
    DT3 = np.asarray(D_T_fn(D3, reg_z_over_reg=0.0))
    test_equal(DT3[Nz // 2], DT2[0], tol, "D_T D mid-slice")
    print(f"\t[PASS] 2D->3D consistency {scheme} ({backend})")


def test_cross_implementation(scheme, tol=1e-5, shape=(6, 3, 24, 24), reg_t=0.3):
    """Cross-implementation oracle (``pytv/tests.py:247-361``): the numpy
    float64 path and the jit device path agree on tv, G, D, D^T D."""
    rng = np.random.default_rng(42)
    img = rng.random(shape)
    tv_c, G_c = getattr(tv_CPU, f"tv_{scheme}")(img, reg_time=reg_t)
    tv_t, G_t = getattr(tv_GPU, f"tv_{scheme}")(img, reg_time=reg_t)
    assert abs(tv_c - tv_t) / abs(tv_c) < tol
    test_equal(G_c, G_t, tol, f"G {scheme}")

    D_c = getattr(tv_operators_CPU, f"D_{scheme}")(img, reg_time=reg_t)
    D_t = getattr(tv_operators_GPU, f"D_{scheme}")(img, reg_time=reg_t)
    test_equal(D_c, D_t, tol, f"D {scheme}")
    DT_c = getattr(tv_operators_CPU, f"D_T_{scheme}")(D_c, reg_time=reg_t)
    DT_t = getattr(tv_operators_GPU, f"D_T_{scheme}")(D_t, reg_time=reg_t)
    test_equal(DT_c, DT_t, tol, f"D_T D {scheme}")
    print(f"\t[PASS] cross-implementation equality {scheme}")


def run_CPU_tests():
    """Reference-parity battery on the numpy float64 backend
    (``pytv/tests.py:48-69``)."""
    print("Running CPU (numpy float64) tests:")
    for scheme in _SCHEMES:
        test_operator_transpose(scheme, "cpu")
        test_2D_to_3D(scheme, "cpu")
    print("All CPU tests passed.")
    return True


def run_GPU_tests():
    """Device-backend battery + cross-implementation checks
    (``pytv/tests.py:71-86``) on JAX's default device."""
    print("Running device (jax) tests:")
    for scheme in _SCHEMES:
        test_operator_transpose(scheme, "gpu")
        test_2D_to_3D(scheme, "gpu")
        test_cross_implementation(scheme, tol=1e-4)
    print("All device tests passed.")
    return True


if __name__ == "__main__":
    run_CPU_tests()
    run_GPU_tests()
