"""Tomographic reconstruction: parallel-beam projector + TV-regularized
primal-dual reconstruction.

The reference library exists to regularize iterative CT reconstruction
(``README.md:2``, Boigne et al. IEEE TCI 2022, doi 10.1109/TCI.2022.3215096)
but ships no projector — users bring their own.  This module completes the
workflow on the accelerator:

- :func:`radon` / :func:`make_projector` — differentiable parallel-beam
  forward projector over the canonical ``(Nz, M, N, N)`` volume (bilinear
  sampling, linear in the image), with the **exact adjoint** obtained by
  ``jax.linear_transpose`` — the pair passes the dot-product test to fp
  precision, so primal-dual solvers converge as theory says.
- per-frame angle sets: dynamic CT interleaves projection angles across time
  frames (the paper's setting); ``angles`` may be ``(n_angles,)`` shared or
  ``(M, n_angles)`` per-frame.
- :func:`cp_reconstruct` — Chambolle-Pock for
  ``min_x 1/2 ||A x - b||^2 + reg * TV(x)`` with both duals, device-resident
  ``lax.scan``, step sizes from a power-method estimate of ``||A||``.

The z axis decomposes trivially (parallel beam) — the same (z, t) mesh
sharding as denoising applies, which is exactly why the reference chose the
``(Nz, M, N, N)`` layout (``README.md:235``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import TVConfig


def _slice_radon(img2d, thetas, n_det: int):
    """Parallel-beam Radon transform of one (N, N) slice for all angles.

    Line integral along direction theta: detector coordinate s runs across
    the beam, integration coordinate t along it.  Bilinear sampling keeps the
    map linear in ``img2d``.
    """
    N = img2d.shape[-1]
    c = (N - 1) / 2.0
    s_axis = jnp.arange(n_det, dtype=img2d.dtype) - (n_det - 1) / 2.0
    t_axis = jnp.arange(N, dtype=img2d.dtype) - (N - 1) / 2.0

    def one_angle(theta):
        cos, sin = jnp.cos(theta), jnp.sin(theta)
        S, T = jnp.meshgrid(s_axis, t_axis, indexing="ij")
        rows = c + S * cos + T * sin
        cols = c - S * sin + T * cos
        vals = jax.scipy.ndimage.map_coordinates(
            img2d, [rows, cols], order=1, mode="constant", cval=0.0
        )
        return jnp.sum(vals, axis=-1)

    return jax.vmap(one_angle)(thetas)  # (n_angles, n_det)


def _radon_all_angles(vol, angles, n_det: int):
    """One vmapped projection sweep: ``angles`` is (A,) shared or (M, A)."""
    slice_fn = functools.partial(_slice_radon, n_det=n_det)
    if angles.ndim == 2:
        # vmap over z (shared angles) then over m (per-frame angles)
        over_m = jax.vmap(slice_fn, in_axes=(0, 0))          # (M,N,N),(M,A)
        over_zm = jax.vmap(over_m, in_axes=(0, None))        # (Nz,...)
        return over_zm(vol, angles)
    over_m = jax.vmap(slice_fn, in_axes=(0, None))
    over_zm = jax.vmap(over_m, in_axes=(0, None))
    return over_zm(vol, angles)


_RADON_GATHER_BUDGET = 512 * 1024 * 1024  # bytes of in-flight gather output


def radon(vol, angles, n_det: Optional[int] = None,
          angle_batch: Optional[int] = None):
    """Forward-project a ``(Nz, M, N, N)`` volume.

    angles: ``(n_angles,)`` shared across frames, or ``(M, n_angles)`` with a
    distinct angle set per time frame (dynamic CT).  Returns a sinogram
    ``(Nz, M, n_angles, n_det)``.

    ``angle_batch`` bounds how many angles one vmapped sweep covers: the
    bilinear-gather intermediate is ``Nz*M*B*n_det*N`` elements BEFORE the
    line-integral reduction, which at production sizes (512^2 planes, ~100
    angles) would be terabytes if swept in one shot.  Default: auto-chosen
    so the in-flight gather stays ~512 MB; batches are run sequentially
    under ``lax.map``.  Pass a value to override (or ``angle_batch >=
    n_angles`` to force the single-sweep path).
    """
    vol = jnp.asarray(vol)
    angles = jnp.asarray(angles, vol.dtype)
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det = n_det or N
    A = angles.shape[-1]

    if angle_batch is None:
        per_angle = Nz * M * n_det * N * jnp.dtype(vol.dtype).itemsize
        angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))
    B = min(int(angle_batch), A)
    if B >= A:
        return _radon_all_angles(vol, angles, n_det)

    pad = (-A) % B
    ang = angles
    if pad:
        ang = jnp.concatenate([ang, ang[..., :pad]], axis=-1)
    C = ang.shape[-1] // B
    if ang.ndim == 2:  # per-frame: (M, C*B) -> (C, M, B)
        chunks = jnp.moveaxis(ang.reshape(ang.shape[0], C, B), 1, 0)
    else:
        chunks = ang.reshape(C, B)
    out = jax.lax.map(lambda a: _radon_all_angles(vol, a, n_det), chunks)
    # (C, Nz, M, B, n_det) -> (Nz, M, C*B, n_det)
    out = jnp.moveaxis(out, 0, 2).reshape(Nz, M, C * B, n_det)
    return out[:, :, :A]


_PROJECTOR_METHODS = ("auto", "gather", "spectral")


def _resolve_method(method: str) -> str:
    """'auto' = spectral on accelerators, gather on CPU.  The spectral
    path is gather-free and spectrally accurate (models/ct_spectral.py);
    on CPU the gather path is where the recorded golden parity lives.
    Which of the two is faster on the GPU at production sizes is not
    measured yet."""
    if method not in _PROJECTOR_METHODS:
        raise ValueError(
            f"unknown projector method {method!r}; expected one of "
            f"{_PROJECTOR_METHODS}"
        )
    if method != "auto":
        return method
    return "gather" if jax.default_backend() == "cpu" else "spectral"


import collections

_PROJECTOR_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PROJECTOR_CACHE_MAX = 24
# >= n_subsets + 2 so one spectral SART campaign (8 subset pairs + the
# full-angle pair) plus a reconstruction geometry all stay resident —
# with max=8 the LRU evicted SART's first subset pair on every call,
# which cascaded into a full runner retrace per call.  Eviction only drops pairs
# (and their pinned prepared tables) once a 25th distinct geometry shows
# up; clear_projector_cache() releases everything eagerly.


def clear_projector_cache() -> None:
    """Drop all memoized ``(A, A_T)`` projector pairs AND the derived
    per-geometry caches that pin them (cone precond sums/scales, SART
    normalizer sums, SART runners).  Each cached SPECTRAL projector can
    pin its prepared NUDFT tables in device memory (~400 MB at production
    scale),
    and a wide-cone SART surrogate entry pins S volume-sized column-sum
    arrays — call this between unrelated geometry campaigns to release
    everything."""
    _PROJECTOR_CACHE.clear()
    _CONE_PRECOND_CACHE.clear()
    _SART_SUMS_CACHE.clear()
    _SART_RUNNER_CACHE.clear()


def make_projector(vol_shape, angles, n_det: Optional[int] = None,
                   dtype=jnp.float32, angle_batch: Optional[int] = None,
                   method: str = "auto", precision: Optional[str] = None):
    """Build ``(A, A_T)`` for a fixed geometry.  ``A_T`` is the exact
    transpose of the linear map ``A`` (its vjp — exact since A is linear),
    so ``<y, A x> == <A_T y, x>`` holds to fp precision — the same
    adjointness contract the TV operators satisfy (SURVEY.md section 4
    oracle 1).  ``angle_batch`` as in :func:`radon` (vjp is used rather
    than ``jax.linear_transpose`` because the latter cannot transpose
    through the chunked ``lax.map`` sweep).

    ``method``: ``'gather'`` = bilinear-sampling :func:`radon`,
    ``'spectral'`` = the gather-free DFT+matmul Fourier-slice projector
    (``models/ct_spectral.py`` — spectrally accurate, no gather in
    forward or adjoint), ``'auto'`` (default) = spectral on accelerators,
    gather on CPU.

    ``precision`` (spectral only): matmul precision of the projector's
    contractions — ``'highest'`` (default, full f32), ``'high'`` or
    ``'default'`` (both TF32 on an H100, ~2e-4 relative, a few percent
    faster; see ``ct_spectral._DEFAULT_PRECISION`` for the measured
    costs).

    Memoized on the full geometry: repeated calls return the SAME
    ``(A, A_T)`` function objects, so the solvers' operator-keyed runner
    caches (``solvers.inverse._make_inverse_run``) HIT instead of
    re-tracing and re-compiling per call."""
    ang_np = np.asarray(angles)
    key = (tuple(vol_shape), ang_np.tobytes(), ang_np.shape, n_det,
           jnp.dtype(dtype).name, angle_batch, _resolve_method(method),
           precision)
    hit = _PROJECTOR_CACHE.get(key)
    if hit is not None:
        _PROJECTOR_CACHE.move_to_end(key)   # LRU: hits refresh position
        return hit
    pair = _make_projector_uncached(vol_shape, angles, n_det, dtype,
                                    angle_batch, method, precision)
    if len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
        # evict least-recently-used (each cached spectral projector may
        # pin its prepared NUDFT tables in HBM — ~400 MB at production
        # scale; clear_projector_cache() releases everything)
        _PROJECTOR_CACHE.popitem(last=False)
    _PROJECTOR_CACHE[key] = pair
    return pair


def _make_projector_uncached(vol_shape, angles, n_det, dtype, angle_batch,
                             method, precision=None):
    if _resolve_method(method) == "spectral":
        from .ct_spectral import make_spectral_projector

        # angle_batch and the spectral angle_chunk mean the same thing
        # (angles per sequential sweep), so an explicit memory bound
        # carries across methods instead of being silently dropped
        return make_spectral_projector(vol_shape, angles, n_det=n_det,
                                       dtype=dtype, angle_chunk=angle_batch,
                                       precision=precision)
    angles = jnp.asarray(angles, dtype)
    n_det = n_det or vol_shape[-1]

    def A(x):
        return radon(x, angles, n_det=n_det, angle_batch=angle_batch)

    def A_T(y):
        _, vjp = jax.vjp(A, jnp.zeros(tuple(vol_shape), dtype))
        (x_bar,) = vjp(y)
        return x_bar

    return A, A_T


def estimate_op_norm(A, A_T, vol_shape, n_iter: int = 12, seed: int = 0,
                     dtype=jnp.float32):
    """Power-method estimate of ||A||_2 (for primal-dual step sizes).
    Rides the heavy-operator ``prepare()/apply`` protocol when ``A``
    carries it (``solvers.inverse._operator_proto``), so the spectral
    projectors' NUDFT tables are built once instead of on every scan
    iteration."""
    x = jnp.asarray(
        np.random.default_rng(seed).standard_normal(vol_shape), dtype
    )
    prepare = getattr(A, "prepare", None)
    apply_fn = getattr(A, "apply", None)
    if prepare is not None and apply_fn is not None:
        consts = prepare()
        fwd = functools.partial(apply_fn, consts)
        _, vjp = jax.vjp(fwd, jnp.zeros(tuple(vol_shape), dtype))

        def pair(v):
            (bp,) = vjp(fwd(v))
            return bp
    else:
        def pair(v):
            return A_T(A(v))

    def body(x, _):
        y = pair(x)
        n = jnp.sqrt(jnp.sum(jnp.square(y)))
        return y / jnp.maximum(n, 1e-30), n

    _, norms = jax.lax.scan(body, x / jnp.sqrt(jnp.sum(jnp.square(x))),
                            length=n_iter)
    return jnp.sqrt(norms[-1])


def sinogram_sharding(mesh, shard_time: bool = True):
    """NamedSharding for a ``(Nz, M, n_angles, n_det)`` sinogram on the
    (z, t) mesh.  Parallel-beam CT decomposes exactly along z (the very
    reason the reference chose the (Nz, M, N, N) layout, ``README.md:235``):
    place the sinogram and the volume with matching z/t shardings and the
    jitted :func:`cp_reconstruct` runs SPMD with zero communication in the
    projector — only the TV stencil's one-plane halos and the loss psum."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import T_AXIS, Z_AXIS

    t_spec = T_AXIS if (shard_time and mesh.shape[T_AXIS] > 1) else None
    return NamedSharding(
        mesh, P(Z_AXIS if mesh.shape[Z_AXIS] > 1 else None, t_spec,
                None, None)
    )


def cone_sinogram_sharding(mesh):
    """NamedSharding for a cone-beam ``(M, n_angles, n_det_v, n_det_u)``
    sinogram on a mesh with a 't' axis.  The cone geometry couples z (one
    frame's projection reads the whole z extent), so z stays unsharded —
    but TIME is a pure batch dim of :func:`radon_cone`: shard the sinogram
    and the volume over t and the jitted reconstruction runs SPMD with
    zero communication in the projector (the TV stencil's t halos, when
    ``reg_time > 0``, come from the partitioner)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import T_AXIS

    if T_AXIS not in mesh.shape or mesh.shape[T_AXIS] == 1:
        raise ValueError(
            "cone_sinogram_sharding needs a mesh with a sharded 't' axis — "
            "the cone projector couples z, so time is the only "
            "zero-communication direction (parallel.mesh.make_mesh(z=1, "
            "t=...))"
        )
    return NamedSharding(mesh, P(T_AXIS, None, None, None))


class CPReconResult(NamedTuple):
    x: jax.Array       # reconstructed volume (Nz, M, N, N)
    loss: jax.Array    # per-iteration F(Ax) + reg*TV history
    state: NamedTuple = None  # full solver carry (resume via state=)


def cp_reconstruct(
    sino,
    angles,
    vol_shape,
    n_iter: int = 100,
    reg: float = 1.0,
    cfg: TVConfig = TVConfig(),
    n_det: Optional[int] = None,
    op_norm: Optional[float] = None,
    x_init=None,
    geom=None,
    precond: bool = False,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state=None,
    method: str = "auto",
    dual_dtype: str = None,
    loss_every: int = 1,
    precision: Optional[str] = None,
):
    """TV-regularized reconstruction ``min_x F(A x) + reg TV(x)``
    with the Chambolle-Pock algorithm over the joint operator ``K = [A; D]``
    (step rule ``tau * sigma * (||A||^2 + ||D||^2) <= 1``).  ``geom``
    selects the beam geometry: ``None`` = parallel, :class:`FanBeamGeometry`
    = fan (sinogram ``(Nz, M, n_angles, n_det)``), :class:`ConeBeamGeometry`
    = cone (sinogram ``(M, n_angles, n_det_v, n_det_u)``; ``n_det``
    ignored — detector dims come from the sinogram).  ``fidelity``/
    ``fidelity_weight``/``nonneg`` as in :func:`solvers.inverse.cp_inverse`
    (``fidelity='kl'`` = Poisson counts, ``nonneg=True`` = nonnegative
    attenuation).  ``method`` picks the projector implementation for ANY
    geometry: 'auto' = the gather-free spectral path on accelerators
    (parallel: Fourier-slice NUDFT; fan: rebinning; cone: SSRB + slope
    correction, :func:`..ct_spectral.radon_cone_spectral` — approximate,
    accuracy envelope in PERF.md), bilinear gather on CPU.
    ``precond=True`` works on parallel/fan spectral (the nonnegative-row
    gate passes when ``n_det ~ N``; a much wider detector can expose the
    spectral splat's ringing and trip it — use ``op_norm`` there) and on
    the spectral CONE via the abs-factor surrogate sums + power-method
    step verification (``_spectral_cone_precond_setup`` — the plain
    signed sums were measured to diverge).
    ``dual_dtype`` as in :func:`cp_inverse`: ``'bfloat16'`` halves the
    Nd-channel dual's storage.
    ``precision`` tunes the spectral projector's matmul precision (see
    :func:`make_projector`)."""
    sino = jnp.asarray(sino)
    A, A_T = _select_projector(sino, angles, vol_shape, n_det, geom,
                               method=method, precision=precision)
    from ..solvers.inverse import cp_inverse

    precond_kw = {}
    if precond and isinstance(geom, ConeBeamGeometry) \
            and _resolve_method(method) == "spectral":
        # the spectral cone's slope correction has SIGNED matrix entries,
        # so the plain A(1)/A^T(1) sums underestimate |A| and the
        # preconditioned solve was measured to DIVERGE at production
        # scale.  Instead: abs-factor surrogate sums + a power-method
        # verification of the preconditioned step condition, rescaling
        # all steps by the measured norm.
        sums, scale = _spectral_cone_precond_setup(
            A, A_T, sino.shape, tuple(vol_shape), np.asarray(angles),
            geom, cfg, sino.dtype, precision)
        precond_kw = dict(precond_sums=sums, precond_scale=scale)

    res = cp_inverse(
        A, sino, vol_shape, A_T=A_T, n_iter=n_iter, reg=reg, cfg=cfg,
        op_norm=op_norm, x_init=x_init, precond=precond, fidelity=fidelity,
        fidelity_weight=fidelity_weight, nonneg=nonneg, state=state,
        dual_dtype=dual_dtype, loss_every=loss_every,
        **precond_kw,
    )
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


_CONE_PRECOND_CACHE: dict = {}


def _spectral_cone_precond_setup(A, A_T, sino_shape, vol_shape, ang_np,
                                 geom, cfg, dtype, precision):
    """Preconditioner inputs for the SIGNED spectral cone: ``((row_sum, col_sum), scale)``.

    1. ``cone_spectral_precond_sums`` — the abs-factor surrogate's exact
       row/column sums (bounds the factor-path mass of ``|A|``; the
       spectral splat's ringing tails are the one unbounded part);
    2. power-method measurement of ``rho = ||Sigma^{1/2} K T^{1/2}||``
       for the joint ``K = [A; D]`` with the resulting diagonals — the
       Pock-Chambolle step condition is ``rho <= 1`` (their Lemma 2), so
       ``scale = 1.05 rho`` puts the scaled norm at 0.95 REGARDLESS of
       which side of 1 the surrogate landed on: a loose surrogate
       (measured ~1.65x the signed sums at small cone scale) makes
       ``rho < 1`` and the rescale GROWS the steps back, recovering the
       preconditioner's iteration advantage instead of paying the slack.

    Memoized per (projector identity, cfg, shapes): repeated solves skip
    the surrogate forward+adjoint pair and the 20 power iterations."""
    key = (id(A), cfg, tuple(vol_shape), tuple(sino_shape),
           jnp.dtype(dtype).name)
    hit = _CONE_PRECOND_CACHE.get(key)
    if hit is not None:
        # the cached entry pins A, so the id-based key cannot be reused
        # by a different projector while the entry exists
        return hit[1]
    from .ct_spectral import cone_spectral_precond_sums
    from ..ops.operators import D, D_T, precond_maps
    from ..solvers.inverse import _bind_operator, _operator_proto

    n_det_v, n_det_u = sino_shape[2], sino_shape[3]
    row, col = cone_spectral_precond_sums(
        vol_shape, ang_np, geom, n_det_v=n_det_v, n_det_u=n_det_u,
        dtype=dtype, precision=precision)

    proto = _operator_proto(A)
    consts = A.prepare() if proto else ()
    kw = cfg.kwargs()
    grouped = cfg.norm != "aniso"
    x0 = np.random.default_rng(0).standard_normal(vol_shape)

    @jax.jit
    def rho(v0, row, col, consts):
        A_, _ = _bind_operator(A, A_T, proto, consts, vol_shape, dtype)
        _, vjp = jax.vjp(A_, jnp.zeros(tuple(vol_shape), dtype))
        sig_D, tau = precond_maps(
            vol_shape, cfg.scheme, cfg.reg_z_over_reg, cfg.reg_time,
            fidelity_colsum=col, grouped=grouped)
        floor = 1e-6 * jnp.maximum(jnp.max(row), 1e-30)
        sig_A = (1.0 / jnp.maximum(row, floor)).astype(dtype)
        sqt = jnp.sqrt(tau).astype(dtype)
        sig_D = sig_D.astype(dtype)

        def B(v):
            w = sqt * v
            (a,) = vjp(sig_A * A_(w))
            d = D_T(sig_D * D(w, cfg.scheme, **kw), cfg.scheme, **kw)
            return sqt * (a + d)

        def body(v, _):
            y = B(v)
            n = jnp.sqrt(jnp.sum(jnp.square(y)))
            return y / jnp.maximum(n, 1e-30), n

        v0 = v0 / jnp.sqrt(jnp.sum(jnp.square(v0)))
        _, norms = jax.lax.scan(body, v0, length=20)
        return jnp.sqrt(norms[-1])

    r = float(rho(jnp.asarray(x0, dtype), row, col, consts))
    scale = 1.05 * r
    out = ((row, col), scale)
    if len(_CONE_PRECOND_CACHE) >= 8:
        _CONE_PRECOND_CACHE.pop(next(iter(_CONE_PRECOND_CACHE)))
    _CONE_PRECOND_CACHE[key] = (A, out)
    return out


def _cached_pair(key, builder):
    """``_PROJECTOR_CACHE`` memoization for non-parallel geometry pairs:
    repeated solves must get the SAME function objects so the solvers'
    operator-keyed runner caches hit (see :func:`make_projector`)."""
    hit = _PROJECTOR_CACHE.get(key)
    if hit is not None:
        _PROJECTOR_CACHE.move_to_end(key)
        return hit
    pair = builder()
    if len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
        _PROJECTOR_CACHE.popitem(last=False)
    _PROJECTOR_CACHE[key] = pair
    return pair


def _select_projector(sino, angles, vol_shape, n_det, geom, method="auto",
                      precision=None):
    """Validate the sinogram layout for the requested beam geometry and
    build the matching (A, A_T) projector pair.  All geometry families go
    through the same ``_PROJECTOR_CACHE`` memoization as
    :func:`make_projector` — repeated solves with the same geometry must
    return the SAME function objects so the solvers' operator-keyed
    runner caches hit instead of re-tracing and re-compiling per
    solve."""
    dtype = sino.dtype
    n_angles = jnp.asarray(angles).shape[-1]
    ang_np = np.asarray(angles)

    def cached(kind, builder, *key_extra):
        key = (kind, tuple(vol_shape), ang_np.tobytes(), ang_np.shape,
               jnp.dtype(dtype).name, _resolve_method(method), precision,
               tuple(geom) if geom is not None else None) + key_extra
        return _cached_pair(key, builder)

    if isinstance(geom, ConeBeamGeometry):
        want = (vol_shape[1], n_angles)
        if tuple(sino.shape[:2]) != want:
            raise ValueError(
                f"cone-beam sinogram shape {tuple(sino.shape)} does not "
                f"match vol_shape {tuple(vol_shape)} with {n_angles} angles "
                f"— expected (M={vol_shape[1]}, {n_angles}, n_det_v, "
                f"n_det_u)"
            )
        n_det_v, n_det_u = sino.shape[2], sino.shape[3]
        if _resolve_method(method) == "spectral":
            from .ct_spectral import make_cone_spectral_projector

            return cached("cone-spectral", lambda: (
                make_cone_spectral_projector(
                    vol_shape, angles, geom, n_det_v=n_det_v,
                    n_det_u=n_det_u, dtype=dtype, precision=precision)),
                n_det_v, n_det_u)
        return cached("cone-gather", lambda: (
            make_cone_projector(vol_shape, angles, geom, n_det_v=n_det_v,
                                n_det_u=n_det_u, dtype=dtype)),
            n_det_v, n_det_u)
    want = (vol_shape[0], vol_shape[1], n_angles, n_det or vol_shape[-1])
    if tuple(sino.shape) != want:
        raise ValueError(
            f"sinogram shape {tuple(sino.shape)} does not match "
            f"vol_shape {tuple(vol_shape)} with {n_angles} angles — "
            f"expected {want} (layout (Nz, M, n_angles, n_det))"
        )
    if geom is None:
        return make_projector(vol_shape, angles, n_det=n_det, dtype=dtype,
                              method=method, precision=precision)
    if _resolve_method(method) == "spectral":
        from .ct_spectral import make_fan_spectral_projector

        return cached("fan-spectral", lambda: (
            make_fan_spectral_projector(vol_shape, angles, geom,
                                        n_det=n_det, dtype=dtype,
                                        precision=precision)), n_det)
    return cached("fan-gather", lambda: (
        make_fan_projector(vol_shape, angles, geom, n_det=n_det,
                           dtype=dtype)), n_det)


def tgv_reconstruct(
    sino,
    angles,
    vol_shape,
    n_iter: int = 100,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    axes: str = "2d",
    n_det: Optional[int] = None,
    op_norm: Optional[float] = None,
    x_init=None,
    geom=None,
    precond: bool = False,
    norm: str = "iso",
    huber_delta: float = 1.0,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state=None,
    method: str = "auto",
    dual_dtype: str = None,
    loss_every: int = 1,
):
    """TGV-2-regularized reconstruction — ``cp_reconstruct`` with the
    second-order regularizer ``a1 ||D x - w|| + a0 ||E w||`` instead of TV
    (``solvers.tgv.tgv_inverse``): staircasing-free reconstructions of
    piecewise-linear objects (classic TGV-CT).  Same sinogram layouts and
    ``geom`` selection as :func:`cp_reconstruct`; ``axes`` picks in-plane
    ('2d', per (z, t) slice), volumetric ('3d') or space-time ('4d') TGV
    coupling; ``fidelity``/``fidelity_weight``/``nonneg`` as in
    :func:`cp_reconstruct`; ``method`` as in :func:`cp_reconstruct`.

    ``dual_dtype``/``loss_every`` are accepted for signature symmetry
    with :func:`cp_reconstruct` but NOT implemented by the underlying
    ``tgv_inverse`` — setting them raises rather than being silently
    ignored."""
    if dual_dtype is not None or loss_every != 1:
        raise NotImplementedError(
            "tgv_reconstruct does not support dual_dtype/loss_every — "
            "tgv_inverse keeps its duals in the input's dtype and returns "
            "a full loss series; leave these at their defaults "
            "(dual_dtype=None, loss_every=1)"
        )
    sino = jnp.asarray(sino)
    A, A_T = _select_projector(sino, angles, vol_shape, n_det, geom,
                               method=method)
    from ..solvers.tgv import tgv_inverse

    res = tgv_inverse(
        A, sino, vol_shape, A_T=A_T, n_iter=n_iter, alpha1=alpha1,
        alpha0=alpha0, axes=axes, op_norm=op_norm, x_init=x_init,
        precond=precond, norm=norm, huber_delta=huber_delta,
        fidelity=fidelity, fidelity_weight=fidelity_weight, nonneg=nonneg,
        state=state,
    )
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


class FanBeamGeometry(NamedTuple):
    """Flat-detector (equidistant) fan-beam geometry, in pixel units.

    - ``source_dist``: source-to-isocenter distance (D_so).
    - ``det_dist``: isocenter-to-detector distance (D_od); the detector line
      is perpendicular to the central ray.
    - ``det_spacing``: detector cell pitch.  Defaults (``None``) to the
      magnification ``(D_so + D_od) / D_so`` so n_det = N cells cover the
      magnified object, converging to unit pitch in the parallel limit.
    - ``step``: integration step along each ray (default 1 pixel, the
      parallel projector's implicit step).

    As ``source_dist -> inf`` the fan opens to parallel beam; see
    ``test_fan_parallel_limit``.
    """
    source_dist: float
    det_dist: float = 0.0
    det_spacing: Optional[float] = None
    step: float = 1.0

    @property
    def magnification(self) -> float:
        return (self.source_dist + self.det_dist) / self.source_dist

    def spacing(self) -> float:
        return self.det_spacing if self.det_spacing is not None else self.magnification


def _slice_radon_fan(img2d, betas, n_det: int, geom: FanBeamGeometry):
    """Fan-beam projection of one (N, N) slice: line integral from the point
    source at angle ``beta`` to each flat-detector cell, sampled with
    bilinear interpolation on an equispaced grid along the ray (linear in
    ``img2d``, so the vjp is the exact adjoint).  Sampling covers the
    ball |P| <= 0.75 N around the isocenter (the image fits inside),
    centered at each ray's closest approach."""
    N = img2d.shape[-1]
    c = (N - 1) / 2.0
    dt = img2d.dtype
    pitch = jnp.asarray(geom.spacing(), dt)
    u_axis = (jnp.arange(n_det, dtype=dt) - (n_det - 1) / 2.0) * pitch
    half = 0.75 * N
    n_samples = max(int(np.ceil(2.0 * half / geom.step)), 2)
    ds = 2.0 * half / n_samples
    s_axis = (jnp.arange(n_samples, dtype=dt) + 0.5) * ds - half

    def one_angle(beta):
        cosb, sinb = jnp.cos(beta), jnp.sin(beta)
        # central-ray direction v = (sinb, cosb), detector axis u = (cosb, -sinb)
        # (matches the parallel projector's convention at beta = theta)
        src_r, src_c = -geom.source_dist * sinb, -geom.source_dist * cosb
        det_r = geom.det_dist * sinb + u_axis * cosb
        det_c = geom.det_dist * cosb - u_axis * sinb
        dr, dc = det_r - src_r, det_c - src_c
        inv_len = 1.0 / jnp.sqrt(dr * dr + dc * dc)
        dr, dc = dr * inv_len, dc * inv_len          # unit ray directions
        t_star = -(src_r * dr + src_c * dc)          # closest approach to O
        t = t_star[:, None] + s_axis[None, :]        # (n_det, n_samples)
        rows = c + src_r + t * dr[:, None]
        cols = c + src_c + t * dc[:, None]
        vals = jax.scipy.ndimage.map_coordinates(
            img2d, [rows, cols], order=1, mode="constant", cval=0.0
        )
        return jnp.sum(vals, axis=-1) * ds

    return jax.vmap(one_angle)(betas)  # (n_angles, n_det)


def radon_fan(vol, angles, geom: FanBeamGeometry,
              n_det: Optional[int] = None,
              angle_batch: Optional[int] = None):
    """Fan-beam forward projection of a ``(Nz, M, N, N)`` volume (the beam
    fans in-plane; z decomposes exactly as in parallel geometry, so the same
    (z, t) mesh sharding applies).  ``angles`` is ``(n_angles,)`` shared or
    ``(M, n_angles)`` per-frame; returns ``(Nz, M, n_angles, n_det)``.
    ``angle_batch`` bounds the in-flight gather as in :func:`radon`."""
    vol = jnp.asarray(vol)
    angles = jnp.asarray(angles, vol.dtype)
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det = n_det or N
    A = angles.shape[-1]

    def sweep(v, a):
        fn = functools.partial(_slice_radon_fan, n_det=n_det, geom=geom)
        if a.ndim == 2:
            over_m = jax.vmap(fn, in_axes=(0, 0))
            return jax.vmap(over_m, in_axes=(0, None))(v, a)
        over_m = jax.vmap(fn, in_axes=(0, None))
        return jax.vmap(over_m, in_axes=(0, None))(v, a)

    if angle_batch is None:
        n_samples = int(np.ceil(1.5 * N / geom.step))
        per_angle = Nz * M * n_det * n_samples * jnp.dtype(vol.dtype).itemsize
        angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))
    B = min(int(angle_batch), A)
    if B >= A:
        return sweep(vol, angles)
    pad = (-A) % B
    ang = angles
    if pad:
        ang = jnp.concatenate([ang, ang[..., :pad]], axis=-1)
    C = ang.shape[-1] // B
    if ang.ndim == 2:
        chunks = jnp.moveaxis(ang.reshape(ang.shape[0], C, B), 1, 0)
    else:
        chunks = ang.reshape(C, B)
    out = jax.lax.map(lambda a: sweep(vol, a), chunks)
    out = jnp.moveaxis(out, 0, 2).reshape(Nz, M, C * B, n_det)
    return out[:, :, :A]


def make_fan_projector(vol_shape, angles, geom: FanBeamGeometry,
                       n_det: Optional[int] = None, dtype=jnp.float32,
                       angle_batch: Optional[int] = None):
    """``(A, A_T)`` for a fixed fan-beam geometry; ``A_T`` is the exact
    transpose (vjp of the linear map), same adjointness contract as
    :func:`make_projector`."""
    angles = jnp.asarray(angles, dtype)
    n_det = n_det or vol_shape[-1]

    def A(x):
        return radon_fan(x, angles, geom, n_det=n_det,
                         angle_batch=angle_batch)

    def A_T(y):
        _, vjp = jax.vjp(A, jnp.zeros(tuple(vol_shape), dtype))
        (x_bar,) = vjp(y)
        return x_bar

    return A, A_T


class ConeBeamGeometry(NamedTuple):
    """Circular-trajectory flat-panel cone-beam geometry, in pixel units.

    The source orbits in the volume's central (z) plane; the flat detector
    is perpendicular to the central ray with axes ``u`` (in-plane, like the
    fan detector) and ``v`` (parallel to z).  Rays diverge in BOTH u and v,
    so unlike parallel/fan geometry the z axis no longer decomposes — the
    sinogram drops the leading Nz axis and is laid out
    ``(M, n_angles, n_det_v, n_det_u)``.

    - ``source_dist``: source-to-isocenter distance (D_so).
    - ``det_dist``: isocenter-to-detector distance (D_od).
    - ``det_spacing_u`` / ``det_spacing_v``: detector pitch per axis;
      ``None`` defaults to the magnification ``(D_so + D_od) / D_so`` so
      ``n_det_u = N`` / ``n_det_v = Nz`` cells cover the magnified object.
    - ``step``: integration step along each ray (pixels).

    As ``source_dist -> inf`` the cone closes to parallel beam and detector
    row ``v`` reads slice ``z = v`` (``test_cone_parallel_limit``).
    """
    source_dist: float
    det_dist: float = 0.0
    det_spacing_u: Optional[float] = None
    det_spacing_v: Optional[float] = None
    step: float = 1.0

    @property
    def magnification(self) -> float:
        return (self.source_dist + self.det_dist) / self.source_dist

    def spacing_u(self) -> float:
        return (self.det_spacing_u if self.det_spacing_u is not None
                else self.magnification)

    def spacing_v(self) -> float:
        return (self.det_spacing_v if self.det_spacing_v is not None
                else self.magnification)


def _frame_radon_cone(vol3d, betas, n_det_v: int, n_det_u: int,
                      geom: ConeBeamGeometry):
    """Cone-beam projection of one time frame's (Nz, N, N) volume: line
    integral from the point source at orbit angle ``beta`` to each detector
    cell (v, u), trilinear sampling on an equispaced grid along the ray
    (linear in the volume — the vjp is the exact adjoint).  Sampling covers
    |P| <= 0.75 max(N, Nz) around the isocenter, centered at each ray's
    closest approach."""
    Nz, N = vol3d.shape[0], vol3d.shape[-1]
    cz, c = (Nz - 1) / 2.0, (N - 1) / 2.0
    dt = vol3d.dtype
    pu = jnp.asarray(geom.spacing_u(), dt)
    pv = jnp.asarray(geom.spacing_v(), dt)
    u_axis = (jnp.arange(n_det_u, dtype=dt) - (n_det_u - 1) / 2.0) * pu
    v_axis = (jnp.arange(n_det_v, dtype=dt) - (n_det_v - 1) / 2.0) * pv
    half = 0.75 * max(N, Nz)
    n_samples = max(int(np.ceil(2.0 * half / geom.step)), 2)
    ds = 2.0 * half / n_samples
    s_axis = (jnp.arange(n_samples, dtype=dt) + 0.5) * ds - half
    V, U = jnp.meshgrid(v_axis, u_axis, indexing="ij")  # (n_det_v, n_det_u)

    def one_angle(beta):
        cosb, sinb = jnp.cos(beta), jnp.sin(beta)
        # (z, r, c) frame: source in the central z plane, same in-plane
        # convention as the fan projector (central ray (sinb, cosb))
        src_r, src_c = -geom.source_dist * sinb, -geom.source_dist * cosb
        det_r = geom.det_dist * sinb + U * cosb
        det_c = geom.det_dist * cosb - U * sinb
        dz, dr, dc = V, det_r - src_r, det_c - src_c
        inv_len = 1.0 / jnp.sqrt(dz * dz + dr * dr + dc * dc)
        dz, dr, dc = dz * inv_len, dr * inv_len, dc * inv_len
        t_star = -(src_r * dr + src_c * dc)       # closest approach to O
        t = t_star[..., None] + s_axis            # (n_det_v, n_det_u, S)
        zs = cz + t * dz[..., None]
        rows = c + src_r + t * dr[..., None]
        cols = c + src_c + t * dc[..., None]
        vals = jax.scipy.ndimage.map_coordinates(
            vol3d, [zs, rows, cols], order=1, mode="constant", cval=0.0
        )
        return jnp.sum(vals, axis=-1) * ds

    return jax.vmap(one_angle)(betas)  # (n_angles, n_det_v, n_det_u)


def radon_cone(vol, angles, geom: ConeBeamGeometry,
               n_det_v: Optional[int] = None, n_det_u: Optional[int] = None,
               angle_batch: Optional[int] = None):
    """Cone-beam forward projection of a ``(Nz, M, N, N)`` volume; returns
    ``(M, n_angles, n_det_v, n_det_u)`` (no Nz axis — the cone couples z).
    ``angles`` is ``(n_angles,)`` shared or ``(M, n_angles)`` per-frame;
    ``angle_batch`` bounds the in-flight gather as in :func:`radon`."""
    vol = jnp.asarray(vol)
    angles = jnp.asarray(angles, vol.dtype)
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N
    A = angles.shape[-1]

    def sweep(v, a):
        fn = functools.partial(_frame_radon_cone, n_det_v=n_det_v,
                               n_det_u=n_det_u, geom=geom)
        if a.ndim == 2:   # per-frame angle sets
            return jax.vmap(fn, in_axes=(1, 0))(v, a)
        return jax.vmap(fn, in_axes=(1, None))(v, a)

    if angle_batch is None:
        n_samples = int(np.ceil(1.5 * max(N, Nz) / geom.step))
        per_angle = (M * n_det_v * n_det_u * n_samples
                     * jnp.dtype(vol.dtype).itemsize)
        angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))
    B = min(int(angle_batch), A)
    if B >= A:
        return sweep(vol, angles)
    pad = (-A) % B
    ang = angles
    if pad:
        ang = jnp.concatenate([ang, ang[..., :pad]], axis=-1)
    C = ang.shape[-1] // B
    if ang.ndim == 2:
        chunks = jnp.moveaxis(ang.reshape(ang.shape[0], C, B), 1, 0)
    else:
        chunks = ang.reshape(C, B)
    out = jax.lax.map(lambda a: sweep(vol, a), chunks)
    # (C, M, B, V, U) -> (M, C*B, V, U)
    out = jnp.moveaxis(out, 0, 1).reshape(M, C * B, n_det_v, n_det_u)
    return out[:, :A]


def make_cone_projector(vol_shape, angles, geom: ConeBeamGeometry,
                        n_det_v: Optional[int] = None,
                        n_det_u: Optional[int] = None, dtype=jnp.float32,
                        angle_batch: Optional[int] = None):
    """``(A, A_T)`` for a fixed cone-beam geometry; ``A_T`` is the exact
    transpose (vjp of the linear map), same adjointness contract as
    :func:`make_projector`."""
    angles = jnp.asarray(angles, dtype)

    def A(x):
        return radon_cone(x, angles, geom, n_det_v=n_det_v, n_det_u=n_det_u,
                          angle_batch=angle_batch)

    def A_T(y):
        _, vjp = jax.vjp(A, jnp.zeros(tuple(vol_shape), dtype))
        (x_bar,) = vjp(y)
        return x_bar

    return A, A_T


def fdk(sino, angles, geom: ConeBeamGeometry, vol_shape,
        angle_batch: Optional[int] = None, filter_name: str = "ramp",
        method: str = "auto"):
    """Feldkamp-Davis-Kress reconstruction of a cone-beam sinogram
    ``(M, n_angles, n_det_v, n_det_u)`` — the classical analytic cone-beam
    method (Feldkamp et al. 1984): cosine-weight each projection,
    bandlimited Ram-Lak filter along ``u``, then distance-weighted
    backprojection ``sum_beta (D_so / U(x, beta))^2 p_filtered``.  Exact in
    the source plane, approximate off-plane (the usual FDK property).

    The backprojection weight ``pi/(2 n_angles)`` (with the Ram-Lak
    response normalized as in :func:`fbp`) is angular-coverage-independent
    — each unique line direction is covered ``range/pi`` times, which
    cancels the quadrature spacing — but cone-beam DATA completeness wants
    the usual full-circle orbit.  Use directly for well-sampled data, or
    as ``x_init`` for :func:`cp_reconstruct` with the same geometry.
    ``angles`` may be shared ``(n_angles,)`` or per-frame ``(M,
    n_angles)``; ``filter_name`` as in :func:`fbp`.

    ``method`` selects the backprojector: ``'gather'`` is the classical
    per-voxel ``map_coordinates`` form above (``angle_batch`` bounds its
    in-flight gather and applies ONLY to this method — the spectral path
    has no gather to bound), ``'spectral'`` the gather-free rebinning P-FDK
    (:func:`..ct_spectral.fdk_spectral` — de-obliquity weight, cone->
    parallel rebin matmuls, spectral parallel FBP per slice); ``'auto'`` =
    spectral on accelerators, gather on CPU — which makes the production
    cone scale the FIRST place an analytic cone answer (and a
    ``cp_reconstruct`` warm start) exists on-chip at all."""
    sino = jnp.asarray(sino)
    if _resolve_method(method) == "spectral":
        from .ct_spectral import fdk_spectral

        return fdk_spectral(sino, angles, geom, vol_shape,
                            filter_name=filter_name)
    dt = sino.dtype
    angles = jnp.asarray(angles, dt)
    M, A, n_det_v, n_det_u = sino.shape
    Nz, N = vol_shape[0], vol_shape[-1]
    cz, c = (Nz - 1) / 2.0, (N - 1) / 2.0
    D_so = geom.source_dist
    mag = geom.magnification
    pu, pv = geom.spacing_u(), geom.spacing_v()

    # cosine pre-weight in isocenter-scaled detector coordinates
    u_iso = ((np.arange(n_det_u) - (n_det_u - 1) / 2.0) * pu / mag)
    v_iso = ((np.arange(n_det_v) - (n_det_v - 1) / 2.0) * pv / mag)
    Vw, Uw = np.meshgrid(v_iso, u_iso, indexing="ij")
    w = jnp.asarray(D_so / np.sqrt(D_so ** 2 + Uw ** 2 + Vw ** 2), dt)

    H, size = _fourier_ramp(n_det_u, filter_name, dt)

    zc = jnp.arange(Nz, dtype=dt) - cz
    rc = jnp.arange(N, dtype=dt) - c
    R, C2 = jnp.meshgrid(rc, rc, indexing="ij")

    if angle_batch is None:
        per_angle = M * Nz * N * N * jnp.dtype(dt).itemsize
        angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))

    def frame_fdk(p_f, betas):   # p_f (A, V, U)
        filtered = _filter_projections(p_f * w, H, size, n_det_u, dt)

        def one_angle(p, beta):
            cosb, sinb = jnp.cos(beta), jnp.sin(beta)
            U_dist = D_so + R * sinb + C2 * cosb       # (N, N)
            t_u = R * cosb - C2 * sinb
            # detector-plane magnification for this voxel column
            m_det = (D_so + geom.det_dist) / U_dist
            u_idx = t_u * m_det / pu + (n_det_u - 1) / 2.0
            v_idx = (zc[:, None, None] * m_det / pv
                     + (n_det_v - 1) / 2.0)            # (Nz, N, N)
            u3 = jnp.broadcast_to(u_idx, (Nz, N, N))
            vals = jax.scipy.ndimage.map_coordinates(
                p, [v_idx, u3], order=1, mode="constant", cval=0.0
            )
            return vals * jnp.square(D_so / U_dist)

        B = min(int(angle_batch), A)
        if B >= A:
            back = jnp.sum(jax.vmap(one_angle)(filtered, betas), axis=0)
        else:
            pad = (-A) % B
            f, b = filtered, betas
            if pad:
                f = jnp.concatenate(
                    [f, jnp.zeros((pad,) + f.shape[1:], dt)], axis=0)
                b = jnp.concatenate([b, b[:pad]], axis=0)
            nC = f.shape[0] // B
            parts = jax.lax.map(
                lambda pb: jnp.sum(jax.vmap(one_angle)(pb[0], pb[1]), axis=0),
                (f.reshape((nC, B) + f.shape[1:]), b.reshape(nC, B)),
            )
            back = jnp.sum(parts, axis=0)
        return back * (jnp.pi / (2 * A))               # (Nz, N, N)

    if angles.ndim == 2:
        out = jax.vmap(frame_fdk, in_axes=(0, 0))(sino, angles)
    else:
        out = jax.vmap(frame_fdk, in_axes=(0, None))(sino, angles)
    return jnp.moveaxis(out, 0, 1)                     # (Nz, M, N, N)


class SARTResult(NamedTuple):
    x: jax.Array          # reconstructed volume (Nz, M, N, N)
    residual: jax.Array   # per-epoch ||A x - b|| history (n_iter,)


def sart(
    sino,
    angles,
    vol_shape,
    n_iter: int = 10,
    n_subsets: int = 8,
    relax: float = 1.0,
    nonneg: bool = True,
    x_init=None,
    project_fn=None,
    n_det: Optional[int] = None,
    angle_axis: int = 2,
    method: str = "auto",
    precision: Optional[str] = None,
    geom=None,
):
    """Ordered-subsets SART reconstruction (Andersen & Kak 1984; OS splitting
    a la OSEM): each sub-iteration corrects x with one angle subset,

        ``x <- x + relax * A_s^T((b_s - A_s x) / (A_s 1)) / (A_s^T 1)``,

    cycling subsets with stride-interleaved angle ordering (subset k takes
    ``angles[k::n_subsets]``, maximizing angular separation per subset).
    One epoch touches every projection once but updates x ``n_subsets``
    times — typically ~n_subsets-fold fewer epochs than SIRT for the same
    residual.  Runs as a ``lax.scan`` over (epoch, subset) on device.

    Unregularized: use directly for well-sampled data, or as ``x_init`` for
    :func:`cp_reconstruct` (TV-regularized) on sparse/dynamic data.

    ``angles`` is ``(n_angles,)`` shared or ``(M, n_angles)`` per-frame;
    ``n_angles`` must be divisible by ``n_subsets`` (pick a divisor or pad
    the scan).  ``geom`` selects the beam geometry like
    :func:`cp_reconstruct`: ``None`` = parallel,
    :class:`FanBeamGeometry` = fan (sinogram ``(Nz, M, n_angles,
    n_det)``), :class:`ConeBeamGeometry` = cone (sinogram ``(M,
    n_angles, n_det_v, n_det_u)`` — ``angle_axis`` is set to 1
    automatically; detector dims come from the sinogram).  Each geometry
    rides ``method``: 'auto' = the gather-free spectral path on
    accelerators (cone: SSRB + slope correction), bilinear gather on
    CPU.  ``project_fn(vol, angles_subset) -> sino`` overrides the
    projector entirely (then set ``angle_axis`` yourself for non-default
    layouts).

    The spectral path needs concrete per-subset angles, so instead of
    scanning subsets as traced values it builds ONE prepared projector
    per subset (``angles[k::n_subsets]`` is concrete at trace time),
    unrolls the ``n_subsets`` sub-steps inside the epoch and threads
    every subset's NUDFT tables through the jitted epoch scan as traced
    arguments — the same prepare()/apply protocol ``cp_inverse`` uses
    (no tables embedded as program constants).  ``precision`` as in
    :func:`make_projector`.
    """
    sino = jnp.asarray(sino)
    dtype = sino.dtype
    # keep the pre-cast host values for the spectral branches: the f32
    # round-trip perturbs the angles enough to defeat _fan_dense_grid's
    # exact phase-alignment snapping (measured 2% SART parity loss on the
    # cone — the same 16x-accuracy alignment the round-4 theta fold pins)
    ang_host = np.asarray(angles, np.float64)
    angles = jnp.asarray(angles, dtype)
    A = angles.shape[-1]
    if A % n_subsets:
        raise ValueError(
            f"n_angles={A} not divisible by n_subsets={n_subsets}; choose a "
            f"divisor (e.g. {[k for k in range(1, min(A, 17)) if A % k == 0]})"
        )
    n_det = n_det or vol_shape[-1]
    if project_fn is None:
        if isinstance(geom, ConeBeamGeometry):
            angle_axis = 1
            n_det_v, n_det_u = sino.shape[2], sino.shape[3]
            if _resolve_method(method) == "spectral":
                return _sart_spectral(
                    sino, ang_host, vol_shape,
                    n_iter, n_subsets, relax, nonneg, x_init, n_det,
                    dtype, precision, geom=geom, angle_axis=1,
                    det_shape=(n_det_v, n_det_u))
            project_fn = functools.partial(
                radon_cone, geom=geom, n_det_v=n_det_v, n_det_u=n_det_u)
        elif isinstance(geom, FanBeamGeometry):
            if _resolve_method(method) == "spectral":
                return _sart_spectral(
                    sino, ang_host, vol_shape,
                    n_iter, n_subsets, relax, nonneg, x_init,
                    sino.shape[-1], dtype, precision, geom=geom)
            project_fn = functools.partial(radon_fan, geom=geom,
                                           n_det=sino.shape[-1])
        elif geom is not None:
            raise ValueError(
                f"unknown geometry {type(geom).__name__}; expected None "
                f"(parallel), FanBeamGeometry or ConeBeamGeometry"
            )
        elif _resolve_method(method) == "spectral":
            return _sart_spectral(
                sino, ang_host, vol_shape, n_iter,
                n_subsets, relax, nonneg, x_init, n_det, dtype, precision)
        else:
            project_fn = functools.partial(radon, n_det=n_det)

    # stride-interleaved subsets along the angle axis
    idx = np.arange(A).reshape(-1, n_subsets).T          # (S, A//S)
    ang_sub = jnp.stack([angles[..., jnp.asarray(k)] for k in idx])
    sino_sub = jnp.stack([jnp.take(sino, jnp.asarray(k), axis=angle_axis)
                          for k in idx])

    ones_vol = jnp.ones(tuple(vol_shape), dtype)

    def subset_ops(a):
        def P(x):
            return project_fn(x, a)

        def P_T(y):
            _, vjp = jax.vjp(P, jnp.zeros(tuple(vol_shape), dtype))
            (x_bar,) = vjp(y)
            return x_bar

        return P, P_T

    # per-subset normalizers: row sums A_s 1 (sino space), col sums A_s^T 1
    def norms_for(a):
        P, P_T = subset_ops(a)
        row = P(ones_vol)
        col = P_T(jnp.ones_like(row))
        return row, col

    row_sums, col_sums = jax.lax.map(norms_for, ang_sub)

    def sub_step(x, inp):
        a, b_s, row, col = inp
        P, P_T = subset_ops(a)
        # DEAD rows/columns (rays missing the volume, detector rows
        # beyond the slab) are masked RELATIVE to the live scale, not
        # floored absolutely: an absolute 1e-6 floor turns a dead row's
        # tiny nonzero data (e.g. the spectral splat's ringing) into a
        # 1e6x amplified update and blows the solve up
        tol_r = 1e-6 * jnp.max(row)
        tol_c = 1e-6 * jnp.max(col)
        r = jnp.where(row > tol_r, (b_s - P(x)) / jnp.maximum(row, tol_r),
                      0.0)
        upd = jnp.where(col > tol_c, P_T(r) / jnp.maximum(col, tol_c),
                        0.0)
        x = x + relax * upd
        if nonneg:
            x = jnp.maximum(x, 0.0)
        return x, None

    def epoch(x, _):
        x, _ = jax.lax.scan(sub_step, x,
                            (ang_sub, sino_sub, row_sums, col_sums))
        res = jnp.sqrt(jnp.sum(jnp.square(project_fn(x, angles) - sino)))
        return x, res

    x0 = (jnp.zeros(tuple(vol_shape), dtype) if x_init is None
          else jnp.asarray(x_init, dtype))
    x, residuals = jax.lax.scan(jax.jit(epoch), x0, length=n_iter)
    return SARTResult(x=x, residual=residuals)


_SART_RUNNER_CACHE: dict = {}
_SART_SUMS_CACHE: dict = {}


def _sart_cone_sums(applies, consts, pairs, idx, ang_np, vol_shape,
                    det_shape, dtype, precision, geom):
    """Health-gated SART normalizers for the spectral cone (see the
    caller's comment): ONE jitted program computes every subset's
    SIGNED row/column sums through the already-prepared applies; if all
    subsets are well-conditioned (min row/col above 1e-2 of their max)
    the signed sums are returned for the runner to consume directly,
    else the abs-factor surrogate sums are built for all subsets.
    Memoized per (pairs, shapes): the probe and surrogate builds are
    one-time per geometry, and the cached entry pins the pairs so the
    id-based key stays valid for its lifetime."""
    key = (tuple(id(p[0]) for p in pairs), tuple(vol_shape), det_shape,
           jnp.dtype(dtype).name)
    hit = _SART_SUMS_CACHE.get(key)
    if hit is not None:
        return hit[0]
    vol_shape_t = tuple(vol_shape)
    S = len(pairs)

    @jax.jit
    def signed_sums(consts):
        ones = jnp.ones(vol_shape_t, dtype)
        out = []
        for k in range(S):
            fwd = functools.partial(applies[k], consts[k])
            row = fwd(ones)
            _, vjp = jax.vjp(fwd, jnp.zeros(vol_shape_t, dtype))
            (col,) = vjp(jnp.ones_like(row))
            out.append((row, col))
        return out

    sums = signed_sums(tuple(consts))
    healthy = all(
        float(jnp.min(row)) > 1e-2 * float(jnp.max(row))
        and float(jnp.min(col)) > 1e-2 * float(jnp.max(col))
        for row, col in sums)
    if not healthy:
        from .ct_spectral import cone_spectral_precond_sums

        sums = [
            cone_spectral_precond_sums(
                vol_shape_t, ang_np[..., k], geom,
                n_det_v=det_shape[0], n_det_u=det_shape[1], dtype=dtype,
                precision=precision)
            for k in idx]
    out = tuple(sums)
    if len(_SART_SUMS_CACHE) >= 8:
        _SART_SUMS_CACHE.pop(next(iter(_SART_SUMS_CACHE)))
    _SART_SUMS_CACHE[key] = (out, pairs)
    return out


def _sart_spectral(sino, ang_np, vol_shape, n_iter, n_subsets, relax,
                   nonneg, x_init, n_det, dtype, precision, geom=None,
                   angle_axis=2, det_shape=None):
    """Ordered-subsets SART on the gather-free spectral projectors.  Subset
    angles ``ang[k::n_subsets]`` are CONCRETE at trace time, so each
    subset gets its own prepared projector (memoized through
    ``_PROJECTOR_CACHE``, so repeated solves reuse both the pairs and
    this runner); the sub-steps are unrolled inside the scanned epoch
    with every subset's NUDFT tables threaded as traced arguments.
    Mathematically identical to the generic :func:`sart` loop with
    ``project_fn = spectral`` — asserted against a plain-closure
    reference in tests/test_ct_spectral.py.  ``geom=None`` = parallel,
    fan keeps the ``(Nz, M, A, n_det)`` layout, cone uses
    ``angle_axis=1`` with ``det_shape=(n_det_v, n_det_u)``."""
    S = n_subsets
    idx = np.arange(ang_np.shape[-1]).reshape(-1, S).T   # (S, A//S)

    def pair_for(a):
        if geom is None:
            return make_projector(vol_shape, a, n_det=n_det, dtype=dtype,
                                  method="spectral", precision=precision)
        key_base = (a.tobytes(), a.shape, tuple(vol_shape),
                    jnp.dtype(dtype).name, precision, tuple(geom))
        if isinstance(geom, ConeBeamGeometry):
            from .ct_spectral import make_cone_spectral_projector

            return _cached_pair(
                ("cone-spectral",) + key_base + det_shape,
                lambda: make_cone_spectral_projector(
                    vol_shape, a, geom, n_det_v=det_shape[0],
                    n_det_u=det_shape[1], dtype=dtype,
                    precision=precision))
        from .ct_spectral import make_fan_spectral_projector

        return _cached_pair(
            ("fan-spectral",) + key_base + (n_det,),
            lambda: make_fan_spectral_projector(
                vol_shape, a, geom, n_det=n_det, dtype=dtype,
                precision=precision))

    pairs = [pair_for(ang_np[..., k]) for k in idx]
    full_A, _ = pair_for(ang_np)

    def proto(A):
        # prepared tables when the eager-table budget allows; else the
        # lazy closure (correct, but rebuilds tables inside the scan)
        prep = getattr(A, "prepare", None)
        return (A.apply, prep()) if prep is not None else \
            ((lambda _c, x: A(x)), ())

    applies, consts = zip(*(proto(p[0]) for p in pairs))
    apply_full, consts_full = proto(full_A)

    # the SSRB cone operator's slope correction has SIGNED entries: at
    # wide cone angles its signed row sums A_s(1) go small or NEGATIVE
    # on oblique rays (measured: 4.7% negative, 42% below 1e-2*max at
    # D_so=1.5N with a 2Nz-row panel) and dividing by them makes the
    # SART sweep violently unstable (residual x1e4 PER EPOCH).  SART's
    # normalization wants |A| sums; the cone leg HEALTH-GATES: signed
    # sums where they are provably well-conditioned (all positive,
    # bounded away from zero — e.g. the production geometry, where the
    # signed sums are ~3x tighter and converge correspondingly faster),
    # the abs-factor surrogate (the preconditioner's machinery) where
    # they are not.  Cached per geometry so repeated solves skip both
    # the probe and the surrogate builds; either way the runner
    # receives the sums as traced args instead of recomputing them.
    sums = ()
    if isinstance(geom, ConeBeamGeometry):
        sums = _sart_cone_sums(
            applies, consts, pairs, idx, ang_np, vol_shape, det_shape,
            dtype, precision, geom)
    has_sums = bool(sums)

    sino_sub = tuple(jnp.take(sino, jnp.asarray(k), axis=angle_axis)
                     for k in idx)

    key = (tuple(id(p[0]) for p in pairs), id(full_A), int(n_iter),
           bool(nonneg), tuple(vol_shape), tuple(sino.shape),
           jnp.dtype(dtype).name, has_sums)
    hit = _SART_RUNNER_CACHE.get(key)
    run = hit[0] if hit is not None else None
    if run is None:
        vol_shape_t = tuple(vol_shape)

        @jax.jit
        def run(x0, relax_t, sino_full, sino_sub, consts, consts_full,
                sums):
            ones_vol = jnp.ones(vol_shape_t, dtype)
            rows, cols, vjps, row_live, col_live = [], [], [], [], []
            for k in range(S):
                fwd = functools.partial(applies[k], consts[k])
                _, vjp = jax.vjp(fwd, jnp.zeros(vol_shape_t, dtype))
                if has_sums:
                    row, col = sums[k]
                else:
                    row = fwd(ones_vol)
                    (col,) = vjp(jnp.ones_like(row))
                # dead rows/columns masked RELATIVE to the live scale
                # (see the generic sub_step: an absolute floor amplifies
                # dead-row ringing 1e6x and blows the solve up)
                tol_r = 1e-6 * jnp.max(row)
                tol_c = 1e-6 * jnp.max(col)
                rows.append(jnp.maximum(row, tol_r))
                cols.append(jnp.maximum(col, tol_c))
                row_live.append(row > tol_r)
                col_live.append(col > tol_c)
                vjps.append(vjp)

            def epoch(x, _):
                for k in range(S):
                    r = jnp.where(
                        row_live[k],
                        (sino_sub[k] - applies[k](consts[k], x))
                        / rows[k], 0.0)
                    (upd,) = vjps[k](r)
                    x = x + relax_t * jnp.where(col_live[k],
                                                upd / cols[k], 0.0)
                    if nonneg:
                        x = jnp.maximum(x, 0.0)
                res = jnp.sqrt(jnp.sum(jnp.square(
                    apply_full(consts_full, x) - sino_full)))
                return x, res

            return jax.lax.scan(epoch, x0, length=n_iter)

        if len(_SART_RUNNER_CACHE) >= 8:
            _SART_RUNNER_CACHE.pop(next(iter(_SART_RUNNER_CACHE)))
        # hold strong refs to the projector pairs: the runner (and its
        # prepared-table memoization) must not outlive them, and the
        # id()-based key must not be reused by a different object
        _SART_RUNNER_CACHE[key] = (run, pairs, full_A)

    x0 = (jnp.zeros(tuple(vol_shape), dtype) if x_init is None
          else jnp.asarray(x_init, dtype))
    x, residuals = run(x0, jnp.asarray(relax, dtype), sino, sino_sub,
                       tuple(consts), consts_full, sums)
    return SARTResult(x=x, residual=residuals)


def _backproject(sino, angles, N: int, angle_batch: Optional[int] = None):
    """Direct (unfiltered) backprojection of one slice's sinogram
    (n_angles, n_det) onto an (N, N) grid — gather-based and NOT the
    exact adjoint of :func:`radon` (use make_projector's A_T inside
    primal-dual solvers; this feeds :func:`fbp`).  ``angle_batch`` bounds
    the in-flight gather like :func:`radon`'s (chunks run under lax.map,
    sequential per slice but still batched across any outer vmap)."""
    n_det = sino.shape[-1]
    A = sino.shape[0]
    c = (N - 1) / 2.0
    r = jnp.arange(N, dtype=sino.dtype) - c
    R, C2 = jnp.meshgrid(r, r, indexing="ij")

    def one_angle(p, theta):
        cos, sin = jnp.cos(theta), jnp.sin(theta)
        s = R * cos - C2 * sin + (n_det - 1) / 2.0
        return jax.scipy.ndimage.map_coordinates(
            p, [s], order=1, mode="constant", cval=0.0
        )

    B = min(int(angle_batch), A) if angle_batch else A
    if B >= A:
        return jnp.sum(jax.vmap(one_angle)(sino, angles), axis=0)
    pad = (-A) % B
    if pad:
        zeros = jnp.zeros((pad,) + sino.shape[1:], sino.dtype)
        sino = jnp.concatenate([sino, zeros], axis=0)
        angles = jnp.concatenate([angles, angles[:pad]], axis=0)
    nC = sino.shape[0] // B
    s_chunks = sino.reshape(nC, B, n_det)
    a_chunks = angles.reshape(nC, B)
    parts = jax.lax.map(
        lambda pa: jnp.sum(jax.vmap(one_angle)(pa[0], pa[1]), axis=0),
        (s_chunks, a_chunks),
    )
    return jnp.sum(parts, axis=0)


_FILTER_WINDOWS = ("ramp", "shepp-logan", "cosine", "hann", "hamming")


def _fourier_ramp(n_det: int, filter_name: str, dtype):
    """Frequency response of the BANDLIMITED ramp filter on a zero-padded
    grid, from the exact real-space taps ``h[0] = 1/4``,
    ``h[odd n] = -1/(pi n)^2``, ``h[even n] = 0`` (Kak & Slaney 1988,
    ch. 3 eq. 61) — unlike sampling ``|f|`` directly this has the correct
    DC response, so reconstructions come out at the right absolute scale
    with no low-frequency bias.  The pad to ``>= 2 n_det`` makes the
    convolution linear instead of circular.  ``filter_name`` applies a
    standard apodization window (noise/ringing vs resolution trade)."""
    if filter_name not in _FILTER_WINDOWS:
        raise ValueError(
            f"unknown filter {filter_name!r}; expected one of "
            f"{_FILTER_WINDOWS}"
        )
    size = max(64, 2 ** int(np.ceil(np.log2(2 * n_det))))
    h = np.zeros(size)
    h[0] = 0.25
    odd = np.arange(1, size // 2, 2)
    h[odd] = -1.0 / (np.pi * odd) ** 2
    h[-odd] = h[odd]
    H = 2.0 * np.real(np.fft.fft(h))
    f = np.fft.fftfreq(size)                   # cycles/sample, |f| <= 0.5
    if filter_name == "shepp-logan":
        nz = f != 0
        H[nz] *= np.sin(np.pi * f[nz]) / (np.pi * f[nz])
    elif filter_name == "cosine":
        H *= np.cos(np.pi * f)
    elif filter_name == "hann":
        H *= 0.5 * (1.0 + np.cos(2.0 * np.pi * f))
    elif filter_name == "hamming":
        H *= 0.54 + 0.46 * np.cos(2.0 * np.pi * f)
    return jnp.asarray(H, dtype), size


def _filter_projections(p, H, size: int, n_det: int, dtype):
    """Zero-pad the detector axis to ``size``, apply the ramp response, and
    crop back — linear convolution with the bandlimited kernel."""
    pad = [(0, 0)] * (p.ndim - 1) + [(0, size - n_det)]
    fp = jnp.fft.fft(jnp.pad(p, pad), axis=-1)
    return jnp.real(jnp.fft.ifft(fp * H, axis=-1)).astype(dtype)[..., :n_det]


def fbp(sino, angles, n_out: Optional[int] = None,
        filter_name: str = "ramp", method: str = "auto"):
    """Filtered backprojection of a ``(Nz, M, n_angles, n_det)`` sinogram —
    the classical analytic reconstruction (bandlimited Ram-Lak filter +
    backprojection), vmapped over z and time.

    Use directly for well-sampled static data, or as ``x_init`` for
    :func:`cp_reconstruct` to cut the iteration count of the TV-regularized
    solve.  ``angles`` may be shared ``(n_angles,)`` or per-frame
    ``(M, n_angles)``.  ``filter_name``: 'ramp' (sharpest), 'shepp-logan',
    'cosine', 'hann' or 'hamming' (progressively smoother — trade noise
    and ringing for resolution on real data).

    ``method`` selects the backprojector: ``'gather'`` interpolates each
    pixel's detector coordinate (``map_coordinates``), ``'spectral'`` uses
    the
    exact adjoint of the gather-free spectral projector (FFT + matmuls);
    ``'auto'`` = spectral on accelerators, gather on CPU.
    """
    sino = jnp.asarray(sino)
    angles_host = angles  # keep pre-conversion values: under a user jit,
    # jnp.asarray turns constants into tracers, but the spectral tables
    # need host values
    angles = jnp.asarray(angles, sino.dtype)
    Nz, M, n_angles, n_det = sino.shape
    N = n_out or n_det

    if _resolve_method(method) == "spectral":
        H, size = _fourier_ramp(n_det, filter_name, sino.dtype)
        filtered = _filter_projections(sino, H, size, n_det, sino.dtype)
        # memoized projector + the prepare()/apply table protocol: the
        # lazy A_T rebuilds the NUDFT tables IN-TRACE on every call;
        # the hoisted tables cut the backprojection to
        # the matmul cost and repeated fbp/fdk calls reuse both the
        # pair and its device-resident tables
        A, A_T = make_projector((Nz, M, N, N), angles_host,
                                n_det=n_det, dtype=sino.dtype,
                                method="spectral")
        prep = getattr(A, "prepare", None)
        if prep is not None:
            consts = prep()
            fwd = functools.partial(A.apply, consts)
            _, vjp = jax.vjp(fwd, jnp.zeros((Nz, M, N, N), sino.dtype))
            (bp,) = vjp(filtered)
        else:
            bp = A_T(filtered)
        return bp * (jnp.pi / (2 * n_angles))

    per_angle = Nz * M * N * N * jnp.dtype(sino.dtype).itemsize
    angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))

    H, size = _fourier_ramp(n_det, filter_name, sino.dtype)

    def slice_fbp(p, thetas):
        filtered = _filter_projections(p, H, size, n_det, sino.dtype)
        return _backproject(filtered, thetas, N,
                            angle_batch=angle_batch) * (jnp.pi / (2 * n_angles))

    per_frame = angles.ndim == 2
    if per_frame:
        over_m = jax.vmap(slice_fbp, in_axes=(0, 0))
        return jax.vmap(over_m, in_axes=(0, None))(sino, angles)
    over_m = jax.vmap(slice_fbp, in_axes=(0, None))
    return jax.vmap(over_m, in_axes=(0, None))(sino, angles)
