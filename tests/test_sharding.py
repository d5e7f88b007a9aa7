"""Sharded-path tests on the 8-virtual-CPU-device mesh (SURVEY.md section 4
"multi-host tests"): the shard_map halo-exchange operators must be slot-exact
with the single-device path, keep D/D_T adjointness across shard edges
(SURVEY.md section 7 hard part 2), and the sharded CP solver must track the
unsharded solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytv4d_tpu as ptv
from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.ops import operators as ops
from pytv4d_tpu.parallel import (
    make_mesh,
    make_sharded_cp_solver,
    shard_volume,
    sharded_D,
    sharded_D_T,
    sharded_tv_and_subgrad,
)
from pytv4d_tpu.solvers.cp import chambolle_pock, init_state

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

SCHEMES = ("upwind", "downwind", "central", "hybrid")


def _mesh42():
    return make_mesh(z=4, t=2)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_D_matches_local(scheme):
    rng = np.random.default_rng(31)
    shape = (8, 4, 16, 16)
    img = rng.random(shape)
    cfg = TVConfig(scheme=scheme, reg_time=0.5, reg_z_over_reg=0.7)
    mesh = _mesh42()
    x = shard_volume(jnp.asarray(img), mesh)
    D_sharded = sharded_D(mesh, cfg, shape)(x)
    D_local = ops.D(jnp.asarray(img), scheme, **cfg.kwargs())
    np.testing.assert_allclose(np.asarray(D_sharded), np.asarray(D_local),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_D_T_matches_local(scheme):
    rng = np.random.default_rng(32)
    shape = (8, 4, 16, 16)
    cfg = TVConfig(scheme=scheme, reg_time=0.5)
    from pytv4d_tpu.core.schemes import num_channels

    Nd = num_channels(scheme, 8, 4, cfg.reg_z_over_reg, cfg.reg_time)
    y = rng.random((8, Nd, 4, 16, 16))
    mesh = _mesh42()
    DT_sharded = sharded_D_T(mesh, cfg, shape)(jnp.asarray(y))
    DT_local = ops.D_T(jnp.asarray(y), scheme, **cfg.kwargs())
    np.testing.assert_allclose(np.asarray(DT_sharded), np.asarray(DT_local),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("scheme", ["hybrid", "central"])
def test_sharded_adjointness(scheme):
    """Oracle 1 on the sharded path: cross-shard-edge scatter contributions
    must keep <Y, D X> == <D^T Y, X> exactly."""
    rng = np.random.default_rng(33)
    shape = (8, 4, 16, 16)
    cfg = TVConfig(scheme=scheme, reg_time=0.8, reg_z_over_reg=0.4)
    from pytv4d_tpu.core.schemes import num_channels

    Nd = num_channels(scheme, 8, 4, cfg.reg_z_over_reg, cfg.reg_time)
    mesh = _mesh42()
    D_fn = sharded_D(mesh, cfg, shape)
    DT_fn = sharded_D_T(mesh, cfg, shape)
    X = jnp.asarray(rng.random(shape))
    Y = jnp.asarray(rng.random((8, Nd, 4, 16, 16)))
    DX = D_fn(X)
    lhs = float(jnp.sum(Y * DX))
    rhs = float(jnp.sum(DT_fn(Y) * X))
    # normalize by the inner-product scale, not |lhs| (which can cancel to ~0)
    scale = float(jnp.linalg.norm(Y.ravel()) * jnp.linalg.norm(DX.ravel()))
    assert abs(lhs - rhs) / scale < 1e-14


def test_sharded_tv_and_subgrad_matches_local():
    rng = np.random.default_rng(34)
    shape = (8, 4, 16, 16)
    img = rng.random(shape)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    mesh = _mesh42()
    tv_s, G_s = sharded_tv_and_subgrad(mesh, cfg, shape)(
        shard_volume(jnp.asarray(img), mesh)
    )
    tv_l, G_l = ptv.ops.tv.tv_and_subgrad(jnp.asarray(img), "hybrid", reg_time=0.5)
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-12)
    np.testing.assert_allclose(np.asarray(G_s), np.asarray(G_l), rtol=1e-11,
                               atol=1e-12)


def test_sharded_cp_tracks_unsharded():
    rng = np.random.default_rng(35)
    shape = (8, 4, 16, 16)
    noisy = jnp.asarray(rng.random(shape) + 10.0)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    mesh = _mesh42()

    ref = chambolle_pock(noisy, n_iter=25, reg=0.5, cfg=cfg)

    solve = make_sharded_cp_solver(mesh, cfg, shape, reg=0.5, n_iter=25)
    st = init_state(noisy, cfg)
    x_sh = shard_volume(noisy, mesh)
    x, y_A, y_D, losses = solve(
        x_sh, shard_volume(st.x, mesh),
        shard_volume(st.y_A, mesh),
        jax.device_put(st.y_D, ptv.parallel.d_volume_sharding(mesh)),
    )
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12)


def test_gspmd_auto_sharding_matches():
    """The plain jnp ops under jit with sharded inputs (GSPMD path) must also
    agree — XLA inserts the halo collectives automatically."""
    rng = np.random.default_rng(36)
    shape = (8, 2, 16, 16)
    img = rng.random(shape)
    mesh = make_mesh(z=8, t=1)
    x = shard_volume(jnp.asarray(img), mesh, shard_time=False)
    tv_s, G_s = ptv.tv_and_subgrad(x, "hybrid")
    tv_l, G_l = ptv.tv_and_subgrad(jnp.asarray(img), "hybrid")
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-12)
    np.testing.assert_allclose(np.asarray(G_s), np.asarray(G_l), rtol=1e-11)


def test_gspmd_full_solvers_sharded():
    """Whole jitted solvers (scan included) run on sharded inputs — XLA
    partitions the entire iteration loop; results match unsharded."""
    rng = np.random.default_rng(37)
    shape = (8, 2, 16, 16)
    noisy = jnp.asarray(rng.random(shape) + 5.0)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    mesh = make_mesh(z=8, t=1)
    noisy_sh = shard_volume(noisy, mesh, shard_time=False)

    from pytv4d_tpu.solvers import admm, subgradient_descent

    ref_cp = chambolle_pock(noisy, n_iter=15, reg=0.4, cfg=cfg)
    got_cp = chambolle_pock(noisy_sh, n_iter=15, reg=0.4, cfg=cfg)
    np.testing.assert_allclose(np.asarray(got_cp.loss), np.asarray(ref_cp.loss),
                               rtol=1e-10)

    ref_gd = subgradient_descent(noisy, n_iter=15, reg=0.4, step_size=1e-2, cfg=cfg)
    got_gd = subgradient_descent(noisy_sh, n_iter=15, reg=0.4, step_size=1e-2, cfg=cfg)
    np.testing.assert_allclose(np.asarray(got_gd.loss), np.asarray(ref_gd.loss),
                               rtol=1e-10)

    ref_ad = admm(noisy, n_iter=8, reg=0.4, cfg=cfg)
    got_ad = admm(noisy_sh, n_iter=8, reg=0.4, cfg=cfg)
    np.testing.assert_allclose(np.asarray(got_ad.loss), np.asarray(ref_ad.loss),
                               rtol=1e-8)


def test_weak_scaling_harness_runs():
    """The weak-scaling sweep executes on the virtual CPU mesh and reports
    sane efficiencies (no perf assertion on CPU)."""
    from pytv4d_tpu.bench import weak_scaling

    res = weak_scaling(base_shape=(2, 2, 16, 16), n_iter=3, repeats=1,
                       device_counts=[1, 2, 4])
    assert set(res) == {1, 2, 4}
    for n, row in res.items():
        assert row["it_per_s"] > 0 and np.isfinite(row["efficiency"])

    from pytv4d_tpu.bench import weak_scaling_tgv

    res = weak_scaling_tgv(base_shape=(2, 2, 16, 16), n_iter=3, repeats=1,
                           device_counts=[1, 2, 4])
    assert set(res) == {1, 2, 4}
    for n, row in res.items():
        assert row["it_per_s"] > 0 and np.isfinite(row["efficiency"])


def test_sharded_aniso_paths():
    """Anisotropic TV on the sharded paths (shard_map tv/G and CP step,
    GSPMD GD) must all track unsharded."""
    from pytv4d_tpu.ops.tv import tv_and_subgrad

    rng = np.random.default_rng(61)
    shape = (8, 4, 16, 16)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5, norm="aniso")
    img = rng.random(shape)
    mesh = _mesh42()

    tv_s, G_s = sharded_tv_and_subgrad(mesh, cfg, shape)(
        shard_volume(jnp.asarray(img), mesh))
    tv_l, G_l = tv_and_subgrad(jnp.asarray(img), "hybrid", reg_time=0.5,
                               norm_type="aniso")
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-12)
    np.testing.assert_allclose(np.asarray(G_s), np.asarray(G_l), rtol=1e-10,
                               atol=1e-12)

    noisy = jnp.asarray(rng.random(shape) + 3.0, jnp.float32)
    ref = chambolle_pock(noisy, n_iter=15, reg=0.4, cfg=cfg)

    solve = make_sharded_cp_solver(mesh, cfg, shape, reg=0.4, n_iter=15)
    st = init_state(noisy, cfg)
    _, _, _, losses = solve(
        shard_volume(noisy, mesh), shard_volume(st.x, mesh),
        shard_volume(st.y_A, mesh),
        jax.device_put(st.y_D, ptv.parallel.d_volume_sharding(mesh)))
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref.loss),
                               rtol=1e-5)

    from pytv4d_tpu.solvers.gd import subgradient_descent

    gref = subgradient_descent(noisy, n_iter=15, reg=0.4, step_size=1e-2,
                               cfg=cfg)
    gsh = subgradient_descent(shard_volume(noisy, mesh), n_iter=15, reg=0.4,
                              step_size=1e-2, cfg=cfg)
    np.testing.assert_allclose(np.asarray(gsh.loss), np.asarray(gref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gsh.x), np.asarray(gref.x),
                               atol=1e-5, rtol=1e-4)


def test_sharded_huber_gd_paths():
    """Huber on the sharded GD paths: the shard_map tv/G (true smooth
    gradient + Huber value under psum) and GSPMD GD on a sharded input
    must both track the unsharded solve."""
    from pytv4d_tpu.ops.tv import tv_and_subgrad
    from pytv4d_tpu.solvers.gd import subgradient_descent

    rng = np.random.default_rng(64)
    shape = (8, 4, 16, 16)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5, norm="huber",
                   huber_delta=0.3)
    img = rng.random(shape)
    mesh = _mesh42()

    tv_s, G_s = sharded_tv_and_subgrad(mesh, cfg, shape)(
        shard_volume(jnp.asarray(img), mesh))
    tv_l, G_l = tv_and_subgrad(jnp.asarray(img), "hybrid", reg_time=0.5,
                               norm_type="huber", huber_delta=0.3)
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-6)
    np.testing.assert_allclose(np.asarray(G_s), np.asarray(G_l),
                               atol=1e-6, rtol=1e-5)

    noisy = jnp.asarray(rng.random(shape) + 2.0, jnp.float32)
    gref = subgradient_descent(noisy, n_iter=15, reg=0.4, step_size=1e-2,
                               cfg=cfg)
    gsh = subgradient_descent(shard_volume(noisy, mesh), n_iter=15, reg=0.4,
                              step_size=1e-2, cfg=cfg)
    np.testing.assert_allclose(np.asarray(gsh.loss), np.asarray(gref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gsh.x), np.asarray(gref.x),
                               atol=1e-5, rtol=1e-4)


def test_sharded_ct_reconstruction():
    """The CT model family under GSPMD on the (z, t) mesh: sinogram and
    volume share z/t shardings, the projector runs with zero communication
    (it vmaps over z/t), the TV stencil halos and loss psum come from the
    partitioner — losses track the unsharded solve."""
    from pytv4d_tpu.models.ct import cp_reconstruct, radon, sinogram_sharding
    from pytv4d_tpu.utils import synthetic_phantom

    truth2d = synthetic_phantom(24).astype(np.float32) / 255.0
    truth = np.stack([np.roll(truth2d, z, axis=0) for z in range(8)])[:, None]
    truth = np.tile(truth, (1, 2, 1, 1))  # (8, 2, 24, 24)
    angles = jnp.linspace(0, np.pi, 16, endpoint=False)
    sino = radon(truth, angles)

    ref = cp_reconstruct(sino, angles, truth.shape, n_iter=30, reg=0.02,
                         op_norm=24.0)

    mesh = _mesh42()
    sino_sh = jax.device_put(jnp.asarray(sino), sinogram_sharding(mesh))
    res = cp_reconstruct(sino_sh, angles, truth.shape, n_iter=30, reg=0.02,
                         op_norm=24.0)
    np.testing.assert_allclose(np.asarray(res.loss), np.asarray(ref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-5, rtol=1e-4)


def test_tgv_sharded_2d_slot_exact():
    """axes='2d' TGV under shard_map: slices are independent subproblems, so
    the sharded solve matches single-device to fp round-off (1e-12, the
    usual XLA fusion/fma freedom across different compiled shapes) and the
    only collective is the loss psum."""
    from pytv4d_tpu.parallel import tgv_denoise_sharded
    from pytv4d_tpu.solvers.tgv import tgv_denoise

    rng = np.random.default_rng(41)
    x = jnp.asarray(rng.random((8, 4, 12, 16)))
    ref = tgv_denoise(x, n_iter=15, alpha1=2.0, alpha0=4.0)
    mesh = _mesh42()
    xs = shard_volume(x, mesh)

    res = tgv_denoise_sharded(xs, mesh, n_iter=15, alpha1=2.0, alpha0=4.0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.w), np.asarray(ref.w),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.loss), np.asarray(ref.loss),
                               rtol=1e-12)

    lean = tgv_denoise_sharded(xs, mesh, n_iter=15, alpha1=2.0, alpha0=4.0,
                               compute_loss=False)
    np.testing.assert_allclose(np.asarray(lean.x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-12)
    assert lean.loss.shape == (0,)


@pytest.mark.parametrize("axes", ["3d", "4d"])
def test_tgv_gspmd_3d_4d(axes):
    """Volumetric / space-time TGV on sharded inputs via GSPMD: the z/t
    coupling crosses shard boundaries, and XLA's partitioner inserts the
    halo collective-permutes for the pad/slice stencils automatically."""
    from pytv4d_tpu.solvers.tgv import tgv_denoise

    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.random((8, 4, 12, 16)))
    ref = tgv_denoise(x, n_iter=15, alpha1=2.0, alpha0=4.0, axes=axes)
    mesh = _mesh42()
    xs = shard_volume(x, mesh)
    res = tgv_denoise(xs, n_iter=15, alpha1=2.0, alpha0=4.0, axes=axes)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.loss), np.asarray(ref.loss),
                               rtol=1e-12)


def test_tgv_sharded_norm_family():
    """aniso / Huber TGV through both sharded paths: the zero-halo 2d
    shard_map and GSPMD coupled 3d on a z-sharded volume match
    single-device to fp round-off."""
    from pytv4d_tpu.parallel import tgv_denoise_sharded
    from pytv4d_tpu.solvers.tgv import tgv_denoise

    rng = np.random.default_rng(53)
    x = jnp.asarray(rng.random((8, 2, 16, 16)) * 4.0)
    mesh = make_mesh(z=4, t=2)
    xs = shard_volume(x, mesh)
    mesh_z = make_mesh(z=4, t=1, devices=jax.devices()[:4])

    for norm, kw in (("aniso", {}), ("huber", {"huber_delta": 0.1})):
        ref2 = tgv_denoise(x, n_iter=10, alpha1=1.0, alpha0=2.0, norm=norm,
                           **kw)
        res2 = tgv_denoise_sharded(xs, mesh, n_iter=10, alpha1=1.0,
                                   alpha0=2.0, norm=norm, **kw)
        np.testing.assert_allclose(np.asarray(res2.x), np.asarray(ref2.x),
                                   rtol=1e-12, atol=1e-12)

        ref3 = tgv_denoise(x, n_iter=10, alpha1=1.0, alpha0=2.0, axes="3d",
                           norm=norm, **kw)
        res3 = tgv_denoise(shard_volume(x, mesh_z, shard_time=False),
                           n_iter=10, alpha1=1.0, alpha0=2.0, axes="3d",
                           norm=norm, **kw)
        np.testing.assert_allclose(np.asarray(res3.x), np.asarray(ref3.x),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(res3.loss),
                                   np.asarray(ref3.loss), rtol=1e-12)

    with pytest.raises(ValueError, match="norm"):
        tgv_denoise(shard_volume(x, mesh_z, shard_time=False), n_iter=2,
                    axes="3d", norm="l1")


def test_sharded_cone_ct_reconstruction():
    """Cone-beam CT under GSPMD: the cone couples z, but time is a pure
    batch dim of the projector — a t-sharded mesh runs the reconstruction
    SPMD with zero projector communication, tracking the unsharded solve."""
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        cone_sinogram_sharding,
        cp_reconstruct,
        radon_cone,
    )
    from pytv4d_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(51)
    truth = np.zeros((6, 4, 16, 16), np.float32)
    truth[2:5, :, 5:12, 5:12] = 1.0
    truth += 0.05 * rng.standard_normal(truth.shape).astype(np.float32)
    geom = ConeBeamGeometry(source_dist=40.0, det_dist=20.0)
    angles = jnp.linspace(0, 2 * np.pi, 12, endpoint=False)
    sino = radon_cone(truth, angles, geom, n_det_v=12)

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    ref = cp_reconstruct(sino, angles, truth.shape, n_iter=20, reg=0.01,
                         geom=geom, op_norm=30.0, cfg=cfg)

    mesh = make_mesh(z=1, t=4, devices=jax.devices()[:4])
    sino_sh = jax.device_put(jnp.asarray(sino), cone_sinogram_sharding(mesh))
    res = cp_reconstruct(sino_sh, angles, truth.shape, n_iter=20, reg=0.01,
                         geom=geom, op_norm=30.0, cfg=cfg)
    np.testing.assert_allclose(np.asarray(res.loss), np.asarray(ref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-5, rtol=1e-4)

    with pytest.raises(ValueError, match="sharded 't' axis"):
        cone_sinogram_sharding(make_mesh(z=4, t=1,
                                         devices=jax.devices()[:4]))


def test_sharded_spectral_cone_ct_reconstruction():
    """The PRODUCTION multi-device cone path: t-sharded
    ``cp_reconstruct(geom=cone, method='spectral')`` (SSRB + slope
    correction, models/ct_spectral.py) must track the unsharded spectral
    solve — M is a pure batch axis of every stage (z-interp matmuls, dense
    spectral radons, rebinning matmuls), so GSPMD shards the whole
    iteration over t with zero projector communication.  The gather-cone
    sharding test above never exercises the spectral cone (CPU auto
    resolves to gather)."""
    from pytv4d_tpu.models.ct import (
        ConeBeamGeometry,
        cone_sinogram_sharding,
        cp_reconstruct,
    )
    from pytv4d_tpu.models.ct_spectral import radon_cone_spectral
    from pytv4d_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(57)
    truth = np.zeros((6, 4, 16, 16), np.float32)
    truth[2:5, :, 5:12, 5:12] = 1.0
    truth += 0.05 * rng.standard_normal(truth.shape).astype(np.float32)
    geom = ConeBeamGeometry(source_dist=40.0, det_dist=20.0)
    angles = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    sino = radon_cone_spectral(jnp.asarray(truth), angles, geom,
                               n_det_v=12)

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    ref = cp_reconstruct(sino, angles, truth.shape, n_iter=20, reg=0.01,
                         geom=geom, op_norm=30.0, cfg=cfg,
                         method="spectral")

    mesh = make_mesh(z=1, t=4, devices=jax.devices()[:4])
    sino_sh = jax.device_put(jnp.asarray(sino), cone_sinogram_sharding(mesh))
    res = cp_reconstruct(sino_sh, angles, truth.shape, n_iter=20, reg=0.01,
                         geom=geom, op_norm=30.0, cfg=cfg,
                         method="spectral")
    np.testing.assert_allclose(np.asarray(res.loss), np.asarray(ref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-5, rtol=1e-4)
