"""Golden parity tests vs recorded reference PyTV-4D outputs.

Fixtures in ``tests/golden/golden_small.npz`` were produced by executing the
reference CPU implementation (see ``tools/make_golden.py``); both the numpy
float64 backend (bit-exact) and the jax backend are checked, plus the
hardcoded headline values from ``README.md:91`` / BASELINE.md.
"""

import os

import numpy as np
import pytest

import pytv4d_tpu as ptv
from pytv4d_tpu import tv_CPU, tv_operators_CPU, tv_operators_GPU, tv_GPU

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_small.npz")
SCHEMES = ("upwind", "downwind", "central", "hybrid")
CASES = {
    "base": dict(),
    "time": dict(reg_time=0.6, reg_z_over_reg=0.4),
    "mask": dict(reg_time=0.5, factor_reg_static=0.25),  # mask added at runtime
    "noz": dict(reg_z_over_reg=0.0, reg_time=1.0),
}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_operator_parity(golden, scheme, case, backend):
    img = golden["img4d"]
    kw = dict(CASES[case])
    if case == "mask":
        kw["mask_static"] = golden["mask"]
    ops = tv_operators_CPU if backend == "numpy" else tv_operators_GPU
    tvm = tv_CPU if backend == "numpy" else tv_GPU
    tol = 1e-12 if backend == "numpy" else 1e-12  # jax path is f64 under x64

    key = f"{scheme}_{case}"
    D = np.asarray(getattr(ops, f"D_{scheme}")(img, **kw))
    np.testing.assert_allclose(D, golden[f"{key}_D"], rtol=tol, atol=tol)
    DT = np.asarray(getattr(ops, f"D_T_{scheme}")(golden[f"{key}_D"], **kw))
    np.testing.assert_allclose(DT, golden[f"{key}_DT"], rtol=tol, atol=tol)
    tv, G = getattr(tvm, f"tv_{scheme}")(img, **kw)
    np.testing.assert_allclose(float(tv), float(golden[f"{key}_tv"]), rtol=tol)
    np.testing.assert_allclose(np.asarray(G), golden[f"{key}_G"], rtol=tol, atol=tol)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_2d_parity(golden, scheme):
    img = golden["img2d"]
    key = f"{scheme}_2d"
    D = tv_operators_CPU.__dict__[f"D_{scheme}"](img)
    np.testing.assert_allclose(D, golden[f"{key}_D"], rtol=1e-14, atol=1e-14)
    tv, G = tv_CPU.__dict__[f"tv_{scheme}"](img)
    np.testing.assert_allclose(float(tv), float(golden[f"{key}_tv"]), rtol=1e-14)
    np.testing.assert_allclose(G, golden[f"{key}_G"], rtol=1e-14, atol=1e-14)


BOUNDARY = os.path.join(os.path.dirname(__file__), "golden",
                        "golden_boundary.npz")
BOUNDARY_CASES = {
    "nz2": dict(reg_time=0.7),
    "m2": dict(reg_time=0.7, reg_z_over_reg=0.6),
    "odd": dict(reg_time=0.5),
}


@pytest.fixture(scope="module")
def golden_boundary():
    return np.load(BOUNDARY)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", list(BOUNDARY_CASES))
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_boundary_parity(golden_boundary, scheme, case, backend):
    """Recorded-reference parity on boundary-heavy shapes: Nz==2 (every z
    difference hits a boundary), M==2 + time coupling (central's upwind
    fallback along t), odd plane sizes.  central x Nz==2 has no reference
    output (the reference CPU crashes there, SURVEY.md section 2.4.1 — our
    behavior for it is covered by the self-consistency/adjointness suites)."""
    if scheme == "central" and case == "nz2":
        pytest.skip("reference defect: unrecordable")
    img = golden_boundary[f"img_{case}"]
    kw = dict(BOUNDARY_CASES[case])
    ops = tv_operators_CPU if backend == "numpy" else tv_operators_GPU
    tvm = tv_CPU if backend == "numpy" else tv_GPU
    tol = 1e-12

    key = f"{scheme}_{case}"
    D = np.asarray(getattr(ops, f"D_{scheme}")(img, **kw))
    np.testing.assert_allclose(D, golden_boundary[f"{key}_D"], rtol=tol,
                               atol=tol)
    DT = np.asarray(
        getattr(ops, f"D_T_{scheme}")(golden_boundary[f"{key}_D"], **kw))
    np.testing.assert_allclose(DT, golden_boundary[f"{key}_DT"], rtol=tol,
                               atol=tol)
    tv, G = getattr(tvm, f"tv_{scheme}")(img, **kw)
    np.testing.assert_allclose(float(tv),
                               float(golden_boundary[f"{key}_tv"]), rtol=tol)
    np.testing.assert_allclose(np.asarray(G), golden_boundary[f"{key}_G"],
                               rtol=tol, atol=tol)


def test_readme_headline_values():
    """The README.md:91 seeded value and BASELINE.md's measured siblings."""
    np.random.seed(0)
    img = np.random.rand(20, 4, 100, 100)
    want = {
        "hybrid": 532166.8251801673,
        "upwind": 516111.71829010965,
        "downwind": 516100.5170811774,
        "central": 256841.60927402685,
    }
    for scheme, value in want.items():
        tv, _ = getattr(tv_CPU, f"tv_{scheme}")(img)
        assert tv == pytest.approx(value, rel=1e-12), scheme
    tv, _ = tv_CPU.tv_hybrid(img, reg_time=1.0)
    assert tv == pytest.approx(599262.1919748212, rel=1e-12)


def test_device_path_headline_value():
    np.random.seed(0)
    img = np.random.rand(20, 4, 100, 100)
    tv, _ = ptv.tv_hybrid(img.astype(np.float32))
    assert float(tv) == pytest.approx(532166.8251801673, rel=1e-4)
