"""The public API surface the docs promise (README layout table,
docs/solvers.md) must exist — guards against accidental export regressions
as modules are refactored."""

import pytv4d_tpu as ptv


def _has(mod, names):
    missing = [n for n in names.split() if not hasattr(mod, n)]
    assert not missing, f"{mod.__name__} missing {missing}"


def test_package_level_compat_surface():
    _has(ptv, "tv_CPU tv_GPU tv_operators_CPU tv_operators_GPU "
              "run_CPU_tests run_GPU_tests "
              "tv_hybrid tv_upwind tv_downwind tv_central "
              "D_hybrid D_T_hybrid compute_L21_norm tv_and_subgrad "
              "cameraman models solvers parallel utils ops core")
    assert not hasattr(ptv, "kernels")


def test_solver_surface():
    _has(ptv.solvers,
         "chambolle_pock chambolle_pock_precond subgradient_descent admm "
         "fista tgv_denoise cp_inverse tgv_inverse reg_discrepancy pd_gap "
         "run_until_converged run_checkpointed save_state load_state "
         "save_state_orbax load_state_orbax exact_transpose power_iteration "
         "gaussian_blur_operator fidelity_dual_prox fidelity_loss "
         "pd_gap_inverse tgv_gap_inverse fidelity_conjugate "
         "CPState CPPrecondState CPResult InverseState InverseResult "
         "TGVResult TGVInverseState ADMMState FISTAResult GDResult "
         "cp_step default_tau")


def test_models_surface():
    _has(ptv.models, "TVDenoiser denoise_tv_chambolle add_noise")
    from pytv4d_tpu.models import ct

    _has(ct, "radon radon_fan radon_cone make_projector make_fan_projector "
             "make_cone_projector cp_reconstruct tgv_reconstruct fbp fdk "
             "sart estimate_op_norm sinogram_sharding "
             "cone_sinogram_sharding FanBeamGeometry ConeBeamGeometry")
    _has(ptv.models, "radon_spectral make_spectral_projector "
                     "radon_fan_spectral make_fan_spectral_projector")
    from pytv4d_tpu import bench

    _has(bench, "bench_ct bench_ct_production bench_solver weak_scaling")


def test_parallel_surface():
    _has(ptv.parallel,
         "make_mesh shard_volume volume_sharding d_volume_sharding "
         "sharded_D sharded_D_T sharded_tv_and_subgrad "
         "make_sharded_cp_solver tgv_denoise_sharded multihost")
    for gone in ("make_sharded_cp_solver_fused", "make_sharded_gd_solver_fused",
                 "make_sharded_tgv_stream_solver", "internal_d_sharding"):
        assert not hasattr(ptv.parallel, gone)


def test_utils_surface():
    _has(ptv.utils,
         "cameraman synthetic_phantom blob_phantom as_volume "
         "has_real_cameraman "
         "IterationTimer cp_traffic_model tgv_traffic_model "
         "roofline_fraction device_peaks trace assert_finite log_run "
         "metrics enable_compile_cache warm_compile")
