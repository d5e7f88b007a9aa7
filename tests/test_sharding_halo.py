"""The sharded denoising paths against single-device on 8 virtual CPU
devices: the explicit ``shard_map`` halo CP solver (every scheme, several
(z, t) meshes, one plane per shard, the fidelity family) and GSPMD — the
single-device CP / GD solvers on sharded inputs — with static masks,
``weight_time`` planes and reduced-precision storage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytv4d_tpu.core.config import TVConfig
from pytv4d_tpu.parallel import (
    d_volume_sharding,
    make_mesh,
    make_sharded_cp_solver,
    shard_volume,
    sharded_tv_and_subgrad,
)
from pytv4d_tpu.solvers.cp import chambolle_pock, init_state
from pytv4d_tpu.solvers.gd import subgradient_descent

SCHEMES = ("upwind", "downwind", "central", "hybrid")


def _halo_cp(mesh, cfg, noisy, n_iter, shard_time=True, **kw):
    solve = make_sharded_cp_solver(mesh, cfg, noisy.shape, reg=0.4,
                                   n_iter=n_iter, shard_time=shard_time, **kw)
    st = init_state(noisy, cfg)
    return solve(
        shard_volume(noisy, mesh, shard_time),
        shard_volume(st.x, mesh, shard_time),
        shard_volume(st.y_A, mesh, shard_time),
        jax.device_put(st.y_D, d_volume_sharding(mesh, shard_time)),
    )


@pytest.mark.parametrize("scheme", SCHEMES)
def test_halo_cp_tracks_unsharded(scheme):
    cfg = TVConfig(scheme=scheme, reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(11).random((8, 4, 16, 16)))
    ref = chambolle_pock(noisy, n_iter=20, reg=0.4, cfg=cfg)
    x, y_A, y_D, losses = _halo_cp(make_mesh(z=4, t=2), cfg, noisy, 20)
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(y_D), np.asarray(ref.state.y_D),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("scheme", ["central", "hybrid"])
def test_halo_cp_one_plane_shards(scheme):
    """One z-plane (and one frame) per shard: every stencil reads its
    neighbours from the halo exchange."""
    cfg = TVConfig(scheme=scheme, reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(12).random((4, 2, 12, 12)))
    ref = chambolle_pock(noisy, n_iter=15, reg=0.4, cfg=cfg)
    x, _, _, losses = _halo_cp(make_mesh(z=4, t=2), cfg, noisy, 15)
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("mesh_zt", [(8, 1), (2, 4), (1, 8)])
def test_halo_cp_mesh_shapes(mesh_zt):
    z, t = mesh_zt
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(13).random((8, 8, 8, 8)))
    ref = chambolle_pock(noisy, n_iter=10, reg=0.4, cfg=cfg)
    x, _, _, losses = _halo_cp(make_mesh(z=z, t=t), cfg, noisy, 10)
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("fidelity,nonneg", [("l1", True), ("kl", False)])
def test_halo_cp_fidelity(fidelity, nonneg):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(14).random((8, 4, 8, 8)) + 1)
    kw = dict(fidelity=fidelity, fidelity_weight=0.8, nonneg=nonneg)
    ref = chambolle_pock(noisy, n_iter=15, reg=0.4, cfg=cfg, **kw)
    x, _, _, losses = _halo_cp(make_mesh(z=8, t=1), cfg, noisy, 15,
                               shard_time=False, **kw)
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("scheme,mesh_zt,shape", [
    ("hybrid", (4, 2), (8, 4, 16, 16)),
    ("central", (2, 4), (4, 8, 16, 16)),
    ("central", (8, 1), (8, 2, 12, 12)),
    ("upwind", (1, 8), (2, 8, 12, 12)),
    ("downwind", (4, 2), (4, 2, 12, 12)),
])
def test_gd_sharded_tracks_unsharded(scheme, mesh_zt, shape):
    """GD two ways on a sharded volume: the GSPMD solver and a
    hand-rolled loop on the shard_map tv/subgradient."""
    cfg = TVConfig(scheme=scheme, reg_time=0.5)
    mesh = make_mesh(z=mesh_zt[0], t=mesh_zt[1])
    noisy = jnp.asarray(np.random.default_rng(15).random(shape))
    ref = subgradient_descent(noisy, n_iter=8, reg=0.4, step_size=1e-2,
                              cfg=cfg)
    sh = subgradient_descent(shard_volume(noisy, mesh), n_iter=8, reg=0.4,
                             step_size=1e-2, cfg=cfg)
    np.testing.assert_allclose(np.asarray(sh.loss), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)

    tv_fn = sharded_tv_and_subgrad(mesh, cfg, shape)
    x = shard_volume(noisy, mesh)
    for i in range(8):
        _, G = tv_fn(x)
        x = x - 1e-2 * ((x - noisy) + 0.4 * G)
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_gspmd_cp_gd_mask_weight(norm):
    """Plane masks and ``weight_time`` ride GSPMD: the single-device
    solvers on a (z, t)-sharded volume match the unsharded solve."""
    rng = np.random.default_rng(16)
    shape = (8, 4, 12, 12)
    mask = np.zeros((1, 1, 12, 12), bool)
    mask[..., 3:8, 2:9] = True
    wt = jnp.asarray(0.5 + rng.random((1, 1, 12, 12)))
    cfg = TVConfig(scheme="hybrid", reg_time=0.7, factor_reg_static=0.3,
                   norm=norm, huber_delta=0.2)
    noisy = jnp.asarray(rng.random(shape))
    kw = dict(n_iter=10, reg=0.4, cfg=cfg, mask_static=jnp.asarray(mask),
              weight_time=wt)
    mesh = make_mesh(z=4, t=2)
    ref = chambolle_pock(noisy, **kw)
    sh = chambolle_pock(shard_volume(noisy, mesh), **kw)
    np.testing.assert_allclose(np.asarray(sh.loss), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)
    gref = subgradient_descent(noisy, step_size=1e-2, **kw)
    gsh = subgradient_descent(shard_volume(noisy, mesh), step_size=1e-2, **kw)
    np.testing.assert_allclose(np.asarray(gsh.loss), np.asarray(gref.loss),
                               rtol=1e-10)


@pytest.mark.parametrize("primary", ["float32", "bfloat16"])
def test_gspmd_cp_bf16_storage(primary):
    """The north-star storage options under GSPMD: bf16 duals (and bf16
    primary) on a sharded volume track the unsharded solve at the same
    storage dtypes, and the sharding survives the solve."""
    shape = (8, 4, 16, 16)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(17).random(shape) * 10,
                        primary)
    mesh = make_mesh(z=4, t=2)
    kw = dict(n_iter=12, reg=1.0, cfg=cfg, dual_dtype="bfloat16")
    ref = chambolle_pock(noisy, **kw)
    sh = chambolle_pock(shard_volume(noisy, mesh), **kw)
    assert sh.x.dtype == jnp.dtype(primary)
    assert len(sh.x.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(sh.loss), np.asarray(ref.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(sh.x, np.float32),
                               np.asarray(ref.x, np.float32),
                               rtol=1e-2, atol=1e-2)
