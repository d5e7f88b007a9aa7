"""True multi-process test: two jax processes (4 virtual CPU devices each)
bootstrap via ``parallel.multihost.initialize``, build a global 8-device
mesh, run the sharded CP solver, and must reproduce the single-process
losses exactly — the DCN-analog path of SURVEY.md section 5."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

WORKER = textwrap.dedent("""
    import sys, os
    sys.path.insert(0, "/root/repo")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    from pytv4d_tpu.parallel import multihost
    multihost.initialize(coordinator_address="127.0.0.1:" + port,
                         num_processes=nproc, process_id=pid)
    import numpy as np, jax.numpy as jnp
    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.parallel import make_sharded_cp_solver, d_volume_sharding
    from pytv4d_tpu.solvers.cp import init_state

    assert jax.process_count() == nproc
    mesh = multihost.global_mesh(z=8, t=1)
    shape = (8, 2, 16, 16)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    noisy = jnp.asarray(np.random.default_rng(0).random(shape) + 3.0,
                        jnp.float32)
    st = init_state(noisy, cfg)
    lo = pid * 4
    dspec = d_volume_sharding(mesh, shard_time=False).spec
    solve = make_sharded_cp_solver(mesh, cfg, shape, reg=0.4, n_iter=10,
                                   shard_time=False)
    g = multihost.host_local_to_global
    x, yA, yD, losses = solve(
        g(mesh, noisy[lo:lo + 4]),
        g(mesh, np.asarray(st.x)[lo:lo + 4]),
        g(mesh, np.asarray(st.y_A)[lo:lo + 4]),
        g(mesh, np.asarray(st.y_D)[lo:lo + 4], dspec),
    )
    jax.block_until_ready(losses)
    print("LOSSES", " ".join(f"{float(v):.8e}" for v in losses))
""")


@pytest.mark.slow
def test_two_process_sharded_cp(tmp_path):
    import jax
    import jax.numpy as jnp

    from pytv4d_tpu.core.config import TVConfig
    from pytv4d_tpu.solvers.cp import chambolle_pock

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = "45991"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd="/root/repo",
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(out)

    losses = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("LOSSES")][0]
        losses.append(np.array([float(v) for v in line.split()[1:]]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=0)

    # must equal the single-process solver
    noisy = jnp.asarray(
        np.random.default_rng(0).random((8, 2, 16, 16)) + 3.0, jnp.float32
    )
    ref = chambolle_pock(noisy, n_iter=10, reg=0.4,
                         cfg=TVConfig(scheme="hybrid", reg_time=0.5))
    np.testing.assert_allclose(losses[0], np.asarray(ref.loss), rtol=1e-5)
