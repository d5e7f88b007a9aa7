"""Gather-free parallel-beam projector: the Fourier-slice theorem on a
linogram frequency grid, evaluated with FFTs and complex MATMULS only.

Why this exists: the bilinear-sampling :func:`..models.ct.radon` builds
giant ``map_coordinates`` gather programs at production sizes
((16,4,512,512) x 96 angles), the sizes the reference library exists to
regularize (``README.md:2,235-250`` of the upstream).  This projector's
HLO is FFT + elementwise transcendentals + batched real matmuls, it is
spectrally accurate, and ``tests/test_ct_spectral.py`` asserts the lowered
module contains NO gather/scatter at all (forward and adjoint).

Math.  Treat the volume slice as point masses at pixel centers,
``f = sum_{r,c} img[r,c] delta(x - x_r, y - y_c)`` with centered
coordinates ``x_r = r - c0``, ``y_c = c - c0``, ``c0 = (N-1)/2``.  A
detector cell at coordinate ``s`` integrates f along the line
``(c0 + s cos t + u sin t, c0 - s sin t + u cos t)`` — the same
parametrization as the gather radon (``models/ct.py::_slice_radon``), so a
mass at (r, c) projects to ``s_rc = x_r cos t - y_c sin t`` and the
projection's Fourier transform is the image transform along a line
(Fourier-slice): ``p_hat(w) = f_hat(w cos t, -w sin t)``.

The linogram trick makes this exact and matmul-shaped: put ONE frequency
component on the padded DFT grid and evaluate the other by a non-uniform
DFT over the remaining axis — a dense contraction:

- near-vertical rays (|sin t| >= |cos t|): column FFT once (all angles),
  then ``G[t,k] = sum_r F_c[r,k] * exp(+2i pi k cot(t) x_r / Np)`` — a
  per-angle (r x k) matmul;
- near-horizontal rays: row FFT once, then the mirrored contraction over
  columns.

Both are EXACT evaluations of ``f_hat`` at the slice frequencies (the
padded FFT is exact at its grid points; the NUDFT sum is finite and
exact), so the only discretization is the detector synthesis
``p[s_j] = dw/(2 pi) sum_k G[t,k] e^{i w_k s_j}`` (another matmul), which
periodizes p with period ``Np * max(|sin t|, |cos t|) >= sqrt(2) N`` —
no wrap-around for objects inside the inscribed disk with ``Np = 2N``.
Accuracy is spectral (trig interpolation) rather than the gather radon's
bilinear O(h^2): against analytic Gaussian line integrals this projector
is ~100x closer than the gather path at N=128 (test_ct_spectral).

Notes:
- ``angles`` must be CONCRETE (host values): the regime split and phase
  tables are built at trace time.  All solver flows satisfy this (the
  geometry is fixed per reconstruction).
- The adjoint (``jax.vjp`` of a linear map == exact transpose) is FFT +
  matmuls too — no scatter.
- Spectral splat kernels ring slightly (Gibbs) so individual operator
  coefficients CAN be negative, but for ``n_det ~ N`` the dips land
  outside the detector extent and ``A(ones)`` stays strictly positive —
  ``precond=True`` passes its nonnegative-row gate and converges
  (test_spectral_precond_reconstruction).  Detectors much wider than the
  projection support may expose the ringing and trip the gate; fall back
  to the power-method/``op_norm`` step rule there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

_SPECTRAL_TABLE_BUDGET = 256 * 1024 * 1024  # bytes of in-flight phase table
# make_spectral_projector precomputes the full NUDFT tables once (device-
# resident constants) when they fit this budget: rebuilding them costs
# ~60 M complex exps PER APPLICATION at production scale, and XLA does not
# reliably hoist the rebuild out of a solver's lax.scan once the program
# is under memory pressure
_SPECTRAL_EAGER_TABLE_BUDGET = 512 * 1024 * 1024


def _concrete_angles(angles):
    try:
        return np.asarray(angles, dtype=np.float64)
    except Exception as e:  # jax tracer, etc.
        raise ValueError(
            "radon_spectral needs concrete (host) angle values — the "
            "regime split and NUDFT phase tables are built at trace time. "
            "Close over the angles (make_projector does) instead of "
            "passing them as a traced argument"
        ) from e


def _chunk_tables(ang, vertical: bool, N: int, Np: int, n_det: int,
                  real_dt, det_spacing: float = 1.0):
    """NUDFT phase tables for one angle set, stored PLANAR as real/imag
    pairs ``(Pr, Pi, Er, Ei)``: ``P[a, r, k]`` is the slice NUDFT,
    ``E[a, k, s]`` the detector synthesis with the regime scale AND the
    FFT centering phase ``e^{+2i pi k c0 / Np}`` folded in (both are
    k-separable, so folding them here removes a full-F-sized complex
    elementwise pass per application).  Pure functions of the geometry —
    input-independent, so they can be built once per projector
    (``make_spectral_projector``) instead of per application.  Planar
    storage feeds real f32 matmuls (see ``_planar_apply``)."""
    c0 = (N - 1) / 2.0
    k = jnp.arange(Np // 2 + 1, dtype=real_dt)
    wk = jnp.where((k == 0) | (k == Np // 2), 1.0, 2.0).astype(real_dt)
    s_j = (jnp.arange(n_det, dtype=real_dt) - (n_det - 1) / 2.0) \
        * jnp.asarray(det_spacing, real_dt)
    x = jnp.arange(N, dtype=real_dt) - c0
    th = jnp.asarray(ang).astype(real_dt)
    sin, cos = jnp.sin(th), jnp.cos(th)
    if vertical:
        # slice frequency v_k = 2 pi k / Np on the grid,
        # u_k = -2 pi k cot(t) / Np via the row NUDFT;
        # w_k = -2 pi k / (Np sin t)
        slope, denom, det_sign = cos / sin, sin, -1.0
    else:
        # u_k on the grid, v_k = -2 pi k tan(t)/Np via the col NUDFT
        # (e^{-i v_k y_c} = e^{+2i pi k tan(t) y_c / Np});
        # w_k = +2 pi k / (Np cos t)
        slope, denom, det_sign = sin / cos, cos, 1.0
    # P[a, r, k] = e^{-i u_k x_r} (vertical) / e^{-i v_k y_c} (horiz.)
    phase = ((2.0 * jnp.pi / Np) * slope[:, None, None]
             * x[None, :, None] * k[None, None, :]).astype(real_dt)
    Pr, Pi = jnp.cos(phase), jnp.sin(phase)
    # detector synthesis p[s_j] = 1/(Np |denom|) sum_k G e^{i w_k s_j},
    # plus the centering phase e^{+2i pi k c0 / Np} of the padded FFT
    dphase = ((det_sign * 2.0 * jnp.pi / Np)
              * (k[None, :, None] / denom[:, None, None])
              * s_j[None, None, :]
              + (2.0 * jnp.pi * c0 / Np) * k[None, :, None]).astype(real_dt)
    scale = (wk[None, :, None] / (Np * jnp.abs(denom))[:, None, None]
             ).astype(real_dt)
    return Pr, Pi, jnp.cos(dphase) * scale, jnp.sin(dphase) * scale


def _planar_apply(Fs, tables, out_dt, precision):
    """Apply one regime bucket's NUDFT pair to the STACKED planar padded
    spectrum ``Fs[(re, im), ..., r, k]`` as REAL f32/f64 matmuls only —
    a complex64 einsum lowers to four float32 dot_generals with
    interleaved-layout transposes; planar data skips that and lets the
    second stage exploit that only the REAL part of the synthesis is
    needed.

    Stage 1 computes all four cross products ``{Fr,Fi} x {Pr,Pi}`` in ONE
    k-batched dot_general by stacking the re/im planes into the matmul's M
    and N dimensions (M doubles to 2*B4): ``prod[i,j,...,a,k] = sum_r Fs[i,...,r,k]
    Ps[j,a,r,k]``.  Stage 2 takes the real part of the detector synthesis
    as a single matmul contracting over the stacked (re/im, k) axis:
    ``Re(G E) = Gr Er - Gi Ei = [Gr, Gi] . [Er; -Ei]``."""
    Pr, Pi, Er, Ei = tables
    Ps = jnp.stack([Pr, Pi])                          # (2, a, r, k)
    prod = jnp.einsum("i...rk,jark->ij...ak", Fs, Ps,
                      precision=precision)
    Gs = jnp.stack([prod[0, 0] - prod[1, 1],          # Gr
                    prod[0, 1] + prod[1, 0]], axis=-2)  # Gi -> (...,a,2,k)
    Es = jnp.stack([Er, -Ei], axis=1)                 # (a, 2, k, s)
    out = jnp.einsum("...ajk,ajks->...as", Gs, Es, precision=precision)
    return out.astype(out_dt)


def _bucket_projection(vol, ang_b, vertical: bool, n_det: int, Np: int,
                       angle_chunk: int, det_spacing: float = 1.0,
                       tables=None, precision=None):
    """Project one regime bucket.  ``vol`` is (B4.., N, N) real; ``ang_b``
    a 1-D CONCRETE angle array, all satisfying |sin| >= |cos| when
    ``vertical`` else |cos| > |sin|.  Returns (..., len(ang_b), n_det).
    ``tables``: optional precomputed planar ``(Pr, Pi, Er, Ei)`` for the
    WHOLE bucket (skips the per-chunk table rebuild and the chunk loop)."""
    N = vol.shape[-1]
    # compute in f32 minimum: phases reach ~1e3 radians at production N,
    # where bf16's 8e-3 relative eps would be whole radians of error —
    # low-precision STORAGE volumes still get full-precision projections
    real_dt = (jnp.float64 if vol.dtype == jnp.float64
               else jnp.float32)
    out_dt = vol.dtype
    if jnp.dtype(vol.dtype).itemsize < 4:
        vol = vol.astype(real_dt)
    # HALF spectrum: the volume is real, so G(-k) = conj(G(k)) and the
    # (real) detector synthesis folds to k = 0..Np/2 with weight 2 on the
    # interior bins — both NUDFT matmuls and the phase tables halve.
    # (The FFT beat a planar DFT-table matmul here on the H100: 6.23 vs
    # 8.25 ms per production A + A^T pair at precision='highest'; PERF.md.)
    if vertical:
        # column FFT once: F[..., r, k] = sum_c img[..,r,c] e^{-2i pi kc/Np}
        F = jnp.fft.rfft(vol, n=Np, axis=-1)
        Fs = jnp.stack([jnp.real(F), jnp.imag(F)])
    else:
        # row FFT once; move the k axis last: F[..., c, k]
        F = jnp.moveaxis(jnp.fft.rfft(vol, n=Np, axis=-2), -2, -1)
        Fs = jnp.stack([jnp.real(F), jnp.imag(F)])
    # (the centering phase e^{+2i pi k c0 / Np} is folded into the E
    # tables — k-separable, so it commutes with the r-contraction)

    if tables is not None:
        return _planar_apply(Fs, tables, out_dt, precision)

    def chunk_fn(ang):
        t = _chunk_tables(ang, vertical, N, Np, n_det, real_dt,
                          det_spacing)
        return _planar_apply(Fs, t, out_dt, precision)

    A = ang_b.shape[0]
    B = min(angle_chunk, A)
    ang_j = jnp.asarray(ang_b, real_dt)
    if B >= A:
        return chunk_fn(ang_j)
    pad = (-A) % B
    if pad:
        ang_j = jnp.concatenate([ang_j, ang_j[:pad]])
    chunks = ang_j.reshape(-1, B)
    out = jax.lax.map(chunk_fn, chunks)          # (C, ..., B, n_det)
    out = jnp.moveaxis(out, 0, -3)               # (..., C, B, n_det)
    out = out.reshape(out.shape[:-3] + (-1, n_det))
    return out[..., :A, :]


def _auto_chunk(N: int, Np: int, n_det: int, itemsize: int) -> int:
    per_angle = (N * Np + Np * n_det) * itemsize  # P + E tables (half-k)
    return max(1, _SPECTRAL_TABLE_BUDGET // max(per_angle, 1))


def _regime_split(ang: np.ndarray):
    """Static vertical/horizontal regime split of a concrete angle set."""
    vert = np.abs(np.sin(ang)) >= np.abs(np.cos(ang))
    return np.nonzero(vert)[0], np.nonzero(~vert)[0]


def _spectral_tables_shared(ang: np.ndarray, N: int, n_det: int, real_dt,
                            det_spacing: float = 1.0):
    """Precomputed per-regime NUDFT tables for one concrete angle set:
    ``{True: (Pr, Pi, Er, Ei) | None, False: ...}`` keyed by the regime,
    aligned with :func:`_regime_split` exactly as
    ``_radon_spectral_shared`` consumes them.  Stored as real/imag float
    pairs (see ``_chunk_tables``); call under jit, so the tables are
    built by one compiled program rather than op by op."""
    Np = 2 * N
    idx_v, idx_h = _regime_split(ang)

    def split(vertical, idx):
        if not idx.size:
            return None
        return _chunk_tables(ang[idx], vertical, N, Np, n_det, real_dt,
                             det_spacing)

    return {True: split(True, idx_v), False: split(False, idx_h)}


def _radon_spectral_shared(vol, ang: np.ndarray, n_det: int,
                           angle_chunk: Optional[int],
                           det_spacing: float = 1.0, tables=None,
                           precision=None):
    """Shared-angle path: ``vol`` (..., N, N), ``ang`` concrete (A,).
    ``tables``: optional precomputed per-regime tables
    (:func:`_spectral_tables_shared`)."""
    N = vol.shape[-1]
    Np = 2 * N
    precision = precision or _DEFAULT_PRECISION
    if angle_chunk is None:
        angle_chunk = _auto_chunk(N, Np, n_det,
                                  jnp.dtype(vol.dtype).itemsize * 2)
    idx_v, idx_h = _regime_split(ang)
    parts = []
    if idx_v.size:
        parts.append(_bucket_projection(
            vol, ang[idx_v], True, n_det, Np, angle_chunk, det_spacing,
            tables=tables[True] if tables else None, precision=precision))
    if idx_h.size:
        parts.append(_bucket_projection(
            vol, ang[idx_h], False, n_det, Np, angle_chunk, det_spacing,
            tables=tables[False] if tables else None, precision=precision))
    out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-2)
    order = np.concatenate([idx_v, idx_h])
    if not np.array_equal(order, np.arange(ang.shape[0])):
        # static un-permutation as a concat of unit slices — jnp.take here
        # would reintroduce a gather into the otherwise gather-free program
        inv = np.argsort(order)
        out = jnp.concatenate(
            [out[..., int(i):int(i) + 1, :] for i in inv], axis=-2)
    return out


_DEFAULT_PRECISION = "highest"
# matmul precision of the NUDFT contractions.  Measured on one NVIDIA
# H100 80GB HBM3 (700 W power limit) at production scale (16,4,512,512) x
# 96 with the FFT DFT, one A + A^T pair, error relative to "highest"
# (PERF.md):
#   "highest"  pair 6.28 ms — full f32, the reference (the default)
#   "high"     pair 5.93 ms — 2.3e-4 relative: the f32 dots run in TF32
#   "default"  pair 6.15 ms — 2.3e-4 relative: TF32 as well
# "high" misses the ~5e-6 this projector is meant to keep over the gather
# path's ~1e-3 by 45x for a 6 % saving, so "highest" is the default.
# Pass precision= to radon_spectral/make_spectral_projector to override.


def radon_spectral(vol, angles, n_det: Optional[int] = None,
                   angle_chunk: Optional[int] = None, _tables=None,
                   precision: Optional[str] = None):
    """Gather-free forward projection of a ``(Nz, M, N, N)`` volume.

    Drop-in for :func:`..models.ct.radon` (same layouts: ``angles`` is
    ``(n_angles,)`` shared or ``(M, n_angles)`` per-frame, returns
    ``(Nz, M, n_angles, n_det)``) with spectral accuracy instead of
    bilinear O(h^2) and no gather in the compiled program.  ``angles``
    must be concrete host values; ``angle_chunk`` bounds the in-flight
    NUDFT table (default: auto for ~256 MB).

    Differences from the gather radon (both are discretizations of the
    same continuous transform; they agree to the gather path's O(h^2)
    interpolation error on smooth objects inside the inscribed disk):

    - integrates FULL lines — the gather radon truncates each ray to N
      samples around its closest approach, clipping corner mass at
      oblique angles;
    - spectral splat kernels ring slightly (Gibbs), so projections of a
      nonnegative image can dip slightly negative just outside the
      object's support (harmless for the primal-dual solvers; for
      ``n_det ~ N`` the ``precond=True`` nonnegative-row gate still
      passes because the dips land outside the detector).
    """
    vol = jnp.asarray(vol)
    if vol.ndim != 4:
        raise ValueError(
            f"radon_spectral expects a rank-4 (Nz, M, N, N) volume, got "
            f"shape {tuple(vol.shape)}"
        )
    N = vol.shape[-1]
    if vol.shape[-2] != N:
        raise ValueError(
            f"radon_spectral supports square in-plane volumes, got "
            f"{vol.shape[-2]} x {N}"
        )
    n_det = n_det or N
    ang = _concrete_angles(angles)
    precision = precision or _DEFAULT_PRECISION
    if ang.ndim == 1:
        return _radon_spectral_shared(vol, ang, n_det, angle_chunk,
                                      tables=_tables, precision=precision)
    if ang.ndim != 2 or ang.shape[0] != vol.shape[1]:
        raise ValueError(
            f"angles must be (n_angles,) shared or (M={vol.shape[1]}, "
            f"n_angles) per-frame, got shape {ang.shape}"
        )
    # per-frame angle sets: each frame has its own (static) regime split
    frames = [
        _radon_spectral_shared(
            vol[:, m], ang[m], n_det, angle_chunk,
            tables=_tables[m] if _tables else None, precision=precision)
        for m in range(ang.shape[0])
    ]
    return jnp.stack(frames, axis=1)


def make_spectral_projector(vol_shape, angles, n_det: Optional[int] = None,
                            dtype=jnp.float32,
                            angle_chunk: Optional[int] = None,
                            precompute_tables: Optional[bool] = None,
                            precision: Optional[str] = None,
                            z_chunk: Optional[int] = None):
    """``(A, A_T)`` for a fixed parallel-beam geometry on the spectral
    path; ``A_T`` is the exact transpose (vjp of the linear map — FFTs and
    matmuls only, no scatter), same adjointness contract as
    :func:`..models.ct.make_projector`.

    ``precompute_tables`` (default: auto when they fit
    ``_SPECTRAL_EAGER_TABLE_BUDGET``): attach a ``prepare()/apply(consts,
    x)`` protocol to ``A`` that lets solvers build the NUDFT phase tables
    ONCE per solve and thread them through the iteration as traced,
    loop-invariant arguments — inside a solver's ``lax.scan`` the lazy
    rebuild (~60 M complex exps per application at production scale)
    otherwise dominates the iteration, because XLA declines to hoist it
    under memory pressure.  The plain ``A(x)`` call always stays lazy
    (safe to jit: no tables are embedded as program constants).
    Set ``False`` to disable the protocol entirely.

    ``z_chunk``: stream each application through ``lax.map`` in
    ``z_chunk``-slice pieces (z is a pure batch axis, values identical) —
    bounds the peak memory of the spectral intermediates so
    north-star-scale volumes ((96,16,512,512): ``Fs`` alone would be
    ~6.5 GB) fit next to the solver state; see :func:`_chunk_over_z`."""
    ang = _concrete_angles(angles)
    n_det = n_det or vol_shape[-1]
    N = vol_shape[-1]
    real_dt = (jnp.float64 if jnp.dtype(dtype) == jnp.float64
               else jnp.float32)
    K = N + 1  # Np // 2 + 1 with Np = 2N
    table_bytes = ang.size * (N * K + K * n_det) * (
        16 if real_dt == jnp.float64 else 8)
    if precompute_tables is None:
        precompute_tables = table_bytes <= _SPECTRAL_EAGER_TABLE_BUDGET
    def A(x):
        # the PLAIN closure stays lazy (tables rebuilt in-trace): safe to
        # jit anywhere without embedding ~400 MB of precomputed tables
        # as HLO constants at production scale
        return radon_spectral(x, ang, n_det=n_det, angle_chunk=angle_chunk,
                              precision=precision)

    def A_T(y):
        _, vjp = jax.vjp(A, jnp.zeros(tuple(vol_shape), dtype))
        (x_bar,) = vjp(y)
        return x_bar

    if precompute_tables:
        # prepare()/apply(consts, x) protocol: solvers thread the tables
        # as TRACED runtime arguments — built once per solve, hoisted out
        # of the iteration scan by construction (XLA's own loop-invariant
        # motion may decline under memory pressure).  prepare() runs
        # under jit and returns real/imag f32 pairs.
        if ang.ndim == 1:
            build = jax.jit(lambda: _spectral_tables_shared(
                ang, N, n_det, real_dt))
        else:
            build = jax.jit(lambda: [
                _spectral_tables_shared(ang[m], N, n_det, real_dt)
                for m in range(ang.shape[0])])

        cache = []

        def prepare():
            # memoized: repeated solves with the same projector reuse the
            # device-resident tables (they live as long as this A does)
            if not cache:
                cache.append(build())
            return cache[0]

        def apply(consts, x):
            return radon_spectral(x, ang, n_det=n_det,
                                  angle_chunk=angle_chunk, _tables=consts,
                                  precision=precision)

        A.prepare, A.apply = prepare, apply

    if z_chunk is not None:
        return _chunk_over_z(A, vol_shape, z_chunk, dtype)
    return A, A_T


def _chunk_over_z(A, vol_shape, z_chunk: int, dtype):
    """Wrap a projector pair so each application streams the volume
    through ``lax.map`` in ``z_chunk``-slice pieces: z is a pure batch
    axis of the parallel geometry, so values are IDENTICAL — only the
    peak memory of the spectral intermediates drops (the padded spectrum
    ``Fs`` alone is ~6.5 GB f32 at the (96,16,512,512) north star; at
    ``z_chunk=8`` it is ~0.5 GB).  The ``prepare()/apply`` protocol is
    preserved (tables are z-independent)."""
    Nz = vol_shape[0]
    if Nz % z_chunk:
        raise ValueError(f"z_chunk={z_chunk} must divide Nz={Nz}")
    C = Nz // z_chunk
    chunk_shape = (z_chunk,) + tuple(vol_shape[1:])

    def _over_chunks(fn, arr):
        parts = arr.reshape((C, z_chunk) + arr.shape[1:])
        out = jax.lax.map(fn, parts)
        return out.reshape((Nz,) + out.shape[2:])

    def A_c(x):
        return _over_chunks(A, x)

    def _adjoint_chunk(yc):
        # vjp at CHUNK shape (the passed A_T closes over the full shape)
        _, vjp = jax.vjp(A, jnp.zeros(chunk_shape, dtype))
        (xc,) = vjp(yc)
        return xc

    def A_T_c(y):
        return _over_chunks(_adjoint_chunk, y)

    proto_apply = getattr(A, "apply", None)
    if getattr(A, "prepare", None) is not None and proto_apply is not None:
        A_c.prepare = A.prepare
        A_c.apply = lambda consts, x: _over_chunks(
            lambda xc: proto_apply(consts, xc), x)
    return A_c, A_T_c


class _FanGrid(NamedTuple):
    """Concrete geometry of the dense parallel grid a fan angle set rebins
    from.  ``thetas`` spans HALF a turn, [0, pi): line integrals are
    unoriented (``R(theta+pi, s) == R(theta, -s)``), so a full-circle fan
    or cone scan folds onto it exactly — this HALVES the dense radon work
    and its NUDFT tables for 2-pi scans.  ``ti``/``si`` are the (A, n_det)
    bilinear resample coordinates into the grid PADDED with ``pad`` wrap
    columns (column n_theta+k = column k with the s axis reversed; see
    ``_fold_pad``)."""
    thetas: np.ndarray
    ds: float
    n_s: int
    ti: np.ndarray
    si: np.ndarray
    pad: int
    # parity factorization of the s coordinate (si is si0[u] or its s-flip
    # by the theta fold): lets the bilinear resample run as two small
    # MATMULS instead of a per-point gather (_rebin_mats/_rebin_apply)
    si0: np.ndarray = None      # (n_det,) parity-0 s coordinate
    parity: np.ndarray = None   # (A, n_det) 0/1 fold parity


import collections

_GRID_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_REBIN_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_HOST_CACHE_MAX = 16
# _fan_dense_grid / _rebin_mats are pure host (numpy) functions of the
# geometry, but Wt is ~38 MB f32 at production cone scale and the
# np.add.at construction is re-run on EVERY trace: memoize
# both so retraces reuse the same arrays (stable object identity also
# lets jit treat repeated closures as equal constants)


def _host_memo(cache, key, builder):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    val = builder()
    if len(cache) >= _HOST_CACHE_MAX:
        cache.popitem(last=False)
    cache[key] = val
    return val


def _fan_dense_grid(ang: np.ndarray, geom, n_det: int, N: int,
                    oversample: float) -> "_FanGrid":
    key = (ang.tobytes(), ang.shape, tuple(geom), n_det, N, oversample)
    return _host_memo(_GRID_CACHE, key, lambda: _fan_dense_grid_uncached(
        ang, geom, n_det, N, oversample))


def _fan_dense_grid_uncached(ang: np.ndarray, geom, n_det: int, N: int,
                             oversample: float) -> "_FanGrid":
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pitch = float(geom.spacing())
    u = (np.arange(n_det) - (n_det - 1) / 2.0) * pitch
    gamma = np.arctan2(u, L)                      # (n_det,)
    theta_q = ang[:, None] + gamma[None, :]       # (A, n_det)
    s_q = D_so * np.sin(gamma)                    # (n_det,)
    s_q = np.broadcast_to(s_q, theta_q.shape)

    # dense parallel grid: theta at ~the fan's own angular resolution
    # (folded mod pi), s at 1/oversample-pixel pitch over the object
    # support (|s| > 0.75 N projects to zero for in-disk objects).  The
    # fold needs n_half * d_theta == pi; when the angular step also
    # divides pi (every equally-spaced full- or half-circle scan), keep
    # d_theta an exact divisor of it and PHASE-align the grid with the
    # source angles — the beta part of every query then lands exactly on
    # a grid line, as the unfolded grid's th0 = min(theta_q) used to
    # arrange, and the central detector column interpolates exactly.
    d_beta = np.pi / ang.shape[0] if ang.shape[0] < 2 else float(
        np.min(np.diff(np.sort(ang))) or np.pi / ang.shape[0])
    d_nom = max(d_beta, 1e-3) / oversample
    m = max(int(np.ceil(d_beta / d_nom)), 1)
    cand = np.pi / (d_beta / m)
    if abs(cand - round(cand)) < 1e-9 and round(cand) >= 4:
        n_half = int(round(cand))
        d_theta = np.pi / n_half
        th_off = float(np.mod(float(ang.ravel()[0]), d_theta))
    else:
        n_half = max(int(np.ceil(np.pi / d_nom)), 4)
        d_theta = np.pi / n_half
        th_off = 0.0
    thetas = th_off + np.arange(n_half) * d_theta
    ds = 1.0 / oversample
    s_max = min(float(np.abs(s_q).max()) + 2.0, 0.75 * N)
    n_s = 2 * int(np.ceil(s_max / ds)) + 1        # odd: s=0 on the grid
    th_f = np.mod(theta_q - th_off, np.pi)
    parity = np.mod(np.floor_divide(theta_q - th_off, np.pi), 2)
    ti = th_f / d_theta                           # in [0, n_half)
    si0 = (np.clip(s_q, -s_max, s_max) + (n_s - 1) / 2.0 * ds) / ds
    si = np.where(parity == 1, (n_s - 1) - si0, si0)
    return _FanGrid(thetas, ds, n_s, ti, si, pad=1,
                    si0=si0[0], parity=parity)


def _fold_pad(dense, pad: int):
    """Append ``pad`` wrap columns to a dense [0, pi) sinogram along the
    theta axis: column ``n_theta + k`` is column ``k`` with the s axis
    reversed (the unoriented-line identity), so bilinear queries that
    straddle theta = pi interpolate exactly across the fold."""
    if not pad:
        return dense
    wrap = jnp.flip(dense[..., :pad, :], axis=-1)
    return jnp.concatenate([dense, wrap], axis=-2)


def _rebin_mats(grid: "_FanGrid", real_dt):
    # memoized per (grid, dtype): grids have stable identity through
    # _GRID_CACHE, and Wt alone is ~38 MB f32 at production cone scale —
    # rebuilding it np.add.at-style on every trace both costs host time
    # and grows distinct HLO constants per retrace.  The
    # cached value pins the grid via the key tuple.
    key = (id(grid), jnp.dtype(real_dt).name)
    hit = _REBIN_CACHE.get(key)
    if hit is not None:
        # the cached entry pins the grid, so the id-based key cannot be
        # reused by a different grid while the entry exists
        _REBIN_CACHE.move_to_end(key)
        return hit[1]
    val = _rebin_mats_uncached(grid, real_dt)
    _host_memo(_REBIN_CACHE, key, lambda: (grid, val))
    return val


def _rebin_mats_uncached(grid: "_FanGrid", real_dt):
    """Host-built weight matrices that express the bilinear fan rebinning
    as two MATMULS (gather-free, unlike ``map_coordinates`` over the
    (A, n_det) query set).

    The s coordinate takes only TWO values per detector column (``si0[u]``
    or its s-flip, by the theta-fold parity), so ``Ws`` (n_s, 2*n_det)
    contracts the dense sinogram's s axis for both parities at once, and
    ``Wt`` (A, n_det, T, 2) holds the theta interpolation weights routed
    to the query's parity slot.  Exactly the 4-term bilinear sum of
    ``map_coordinates(order=1, mode='constant')`` on in-range queries
    (the grid construction clips s and keeps ti < n_theta)."""
    A, U = grid.ti.shape
    n_s = int(grid.n_s)
    T = len(grid.thetas) + grid.pad
    par = grid.parity.astype(np.int64)
    Ws = np.zeros((n_s, U, 2))
    cols = np.arange(U)
    for p in range(2):
        c = grid.si0 if p == 0 else (n_s - 1) - grid.si0
        k = np.floor(c).astype(np.int64)
        f = c - k
        np.add.at(Ws, (k, cols, np.full(U, p)), 1.0 - f)
        np.add.at(Ws, (np.minimum(k + 1, n_s - 1), cols, np.full(U, p)), f)
    Wt = np.zeros((A, U, T, 2))
    t0 = np.floor(grid.ti).astype(np.int64)
    ft = grid.ti - t0
    aa, uu = np.meshgrid(np.arange(A), cols, indexing="ij")
    np.add.at(Wt, (aa, uu, t0, par), 1.0 - ft)
    np.add.at(Wt, (aa, uu, np.minimum(t0 + 1, T - 1), par), ft)
    np_dt = np.dtype(jnp.dtype(real_dt).name)
    return Ws.reshape(n_s, 2 * U).astype(np_dt), Wt.astype(np_dt)


def _rebin_apply(dense, Ws, Wt, precision):
    """Resample a padded dense sinogram ``(..., T, n_s)`` at the fan
    coordinates via the :func:`_rebin_mats` matmuls -> ``(..., A, n_det)``."""
    precision = precision or _DEFAULT_PRECISION
    U = Wt.shape[1]
    d2 = jnp.einsum("...ts,sq->...tq", dense, jnp.asarray(Ws, dense.dtype),
                    precision=precision)
    d2 = d2.reshape(d2.shape[:-1] + (U, 2))
    return jnp.einsum("autp,...tup->...au", jnp.asarray(Wt, dense.dtype),
                      d2, precision=precision)


def radon_fan_spectral(vol, angles, geom, n_det: Optional[int] = None,
                       angle_chunk: Optional[int] = None,
                       oversample: float = 2.0,
                       precision: Optional[str] = None, _tables=None):
    """Fan-beam forward projection via fan-to-parallel REBINNING on the
    spectral projector: a fan ray (source angle ``beta``, flat-detector
    coordinate ``u``) IS the parallel ray at

        theta = beta + gamma,   s = D_so sin(gamma),
        gamma = atan(u / (D_so + D_od)),

    so we evaluate a dense parallel sinogram spectrally (gather-free) and
    bilinearly resample it at the fan coordinates — as two small MATMULS
    (:func:`_rebin_mats`), so the program contains NO gather at all
    (the classical rebinning construction, Kak & Slaney 1988 ch. 3.4.2).

    Drop-in for :func:`..ct.radon_fan` on the same ``FanBeamGeometry``
    (values agree to the combined rebinning-interpolation + gather-path
    O(h^2) error on smooth objects, ~1e-3 relative); exact adjoint via
    ``jax.vjp`` as usual.  ``angles`` must be concrete; ``(n_angles,)``
    shared or ``(M, n_angles)`` per-frame.  ``oversample`` controls the
    dense grid density in BOTH theta (relative to the fan's angular step)
    and s (relative to unit pitch).
    """
    vol = jnp.asarray(vol)
    if vol.ndim != 4 or vol.shape[-2] != vol.shape[-1]:
        raise ValueError(
            f"radon_fan_spectral expects a square-plane rank-4 volume, got "
            f"{tuple(vol.shape)}"
        )
    N = vol.shape[-1]
    n_det = n_det or N
    ang = _concrete_angles(angles)
    if ang.ndim == 2:
        if ang.shape[0] != vol.shape[1]:
            raise ValueError(
                f"per-frame angles must be (M={vol.shape[1]}, n_angles), "
                f"got {ang.shape}"
            )
        frames = [
            radon_fan_spectral(vol[:, m:m + 1], ang[m], geom, n_det=n_det,
                               angle_chunk=angle_chunk,
                               oversample=oversample,
                               precision=precision,
                               _tables=_tables[m] if _tables else None)[:, 0]
            for m in range(ang.shape[0])
        ]
        return jnp.stack(frames, axis=1)

    grid = _fan_dense_grid(ang, geom, n_det, N, oversample)
    dense = _radon_spectral_shared(vol, grid.thetas, grid.n_s, angle_chunk,
                                   det_spacing=grid.ds, tables=_tables,
                                   precision=precision)
    dense = _fold_pad(dense, grid.pad)
    # dense: (Nz, M, n_theta + pad, n_s) -> bilinear resample at the fan
    # coordinates as two matmuls (the dense program stays gather-FREE)
    Ws, Wt = _rebin_mats(grid, dense.dtype)
    return _rebin_apply(dense, Ws, Wt, precision)  # (Nz, M, A, n_det)


def _attach_fan_tables(A_obj, apply_like, ang, geom, n_det, N, oversample,
                       real_dt):
    """Attach the ``prepare()/apply(consts, x)`` heavy-operator protocol
    (see :func:`make_spectral_projector`) for a fan-grid angle set: the
    consts are the NUDFT tables of the DENSE parallel grid the fan (or
    SSRB cone) path rebins from, hoisted out of solver scans."""
    if ang.ndim == 1:
        grids = [_fan_dense_grid(ang, geom, n_det, N, oversample)]
    else:
        grids = [_fan_dense_grid(ang[m], geom, n_det, N, oversample)
                 for m in range(ang.shape[0])]

    def build_all():
        tabs = [_spectral_tables_shared(g.thetas, N, g.n_s, real_dt,
                                        det_spacing=g.ds) for g in grids]
        return tabs[0] if ang.ndim == 1 else tabs

    build = jax.jit(build_all)
    cache = []

    def prepare():
        if not cache:
            cache.append(build())
        return cache[0]

    A_obj.prepare, A_obj.apply = prepare, apply_like
    return A_obj


def make_fan_spectral_projector(vol_shape, angles, geom,
                                n_det: Optional[int] = None,
                                dtype=jnp.float32,
                                angle_chunk: Optional[int] = None,
                                oversample: float = 2.0,
                                precision: Optional[str] = None):
    """``(A, A_T)`` for a fixed fan-beam geometry on the rebinned spectral
    path; ``A_T`` is the exact transpose (vjp of the linear map).  Carries
    the same ``prepare()/apply`` table-hoisting protocol as
    :func:`make_spectral_projector` (the consts are the dense parallel
    grid's NUDFT tables)."""
    ang = _concrete_angles(angles)
    n_det = n_det or vol_shape[-1]
    N = vol_shape[-1]
    real_dt = (jnp.float64 if jnp.dtype(dtype) == jnp.float64
               else jnp.float32)

    def A(x):
        return radon_fan_spectral(x, ang, geom, n_det=n_det,
                                  angle_chunk=angle_chunk,
                                  oversample=oversample,
                                  precision=precision)

    def A_T(y):
        _, vjp = jax.vjp(A, jnp.zeros(tuple(vol_shape), dtype))
        (x_bar,) = vjp(y)
        return x_bar

    def apply(consts, x):
        return radon_fan_spectral(x, ang, geom, n_det=n_det,
                                  angle_chunk=angle_chunk,
                                  oversample=oversample,
                                  precision=precision, _tables=consts)

    _attach_fan_tables(A, apply, ang, geom, n_det, N, oversample, real_dt)
    return A, A_T


def _ssrb_weights(geom, Nz: int, n_det_v: int, n_det_u: int, real_dt):
    """Concrete SSRB constants for a cone geometry: the z-interpolation
    matrix ``Wz`` (n_det_v, Nz) mapping volume slices to detector-row
    slices (row v reads the slice at isocenter height
    ``v_iso = v_centered * pv * D_so / (D_so + D_od)``), and the
    obliquity weight ``w`` (n_det_v, n_det_u) = ds_3d/ds_inplane =
    ``sqrt(1 + v^2 / (L^2 + u^2))`` matching the gather cone's 3D
    arc-length integration (``ct._frame_radon_cone``)."""
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pu, pv = float(geom.spacing_u()), float(geom.spacing_v())
    cz = (Nz - 1) / 2.0
    v_det = (np.arange(n_det_v) - (n_det_v - 1) / 2.0) * pv
    u_det = (np.arange(n_det_u) - (n_det_u - 1) / 2.0) * pu
    z_v = cz + v_det * (D_so / L)                  # (V,) slice coordinate
    Wz = np.maximum(0.0, 1.0 - np.abs(z_v[:, None] - np.arange(Nz)[None]))
    w = np.sqrt(1.0 + v_det[:, None] ** 2
                / (L ** 2 + u_det[None, :] ** 2))  # (V, U)
    np_dt = np.dtype(jnp.dtype(real_dt).name)
    return Wz.astype(np_dt), w.astype(np_dt)


def _cone_host_consts(geom, ang: np.ndarray, Nz: int, n_det_v: int,
                      n_det_u: int, N: int, oversample: float):
    """All concrete (host, numpy) constants of the spectral cone path for
    one shared angle set: the dense parallel grid, the fan resample
    coordinates, the z interpolation/derivative matrices, and the
    per-cell ray coefficients.  Geometry: source at in-plane distance
    ``D_so`` and height z=0; a cone ray to detector cell (v, u) has
    in-plane track = the fan ray of column u and height
    ``z(s) = sigma * s`` with ``s`` the in-plane distance from the source
    and ``sigma = v_det*pv / sqrt(L^2 + u_det^2*pu^2)`` (matching
    ``ct._frame_radon_cone``'s normalization exactly)."""
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pu, pv = float(geom.spacing_u()), float(geom.spacing_v())
    cz = (Nz - 1) / 2.0

    from .ct import FanBeamGeometry

    fan = FanBeamGeometry(source_dist=D_so, det_dist=float(geom.det_dist),
                          det_spacing=pu)
    grid = _fan_dense_grid(ang, fan, n_det_u, N, oversample)
    thetas, ds, n_s = grid.thetas, grid.ds, grid.n_s

    u_det = (np.arange(n_det_u) - (n_det_u - 1) / 2.0) * pu
    v_det = (np.arange(n_det_v) - (n_det_v - 1) / 2.0) * pv
    L_ip = np.sqrt(L ** 2 + u_det ** 2)              # (U,)
    sigma = v_det[:, None] / L_ip[None, :]           # (V, U) dz/ds_ip
    obliq = np.sqrt(1.0 + sigma ** 2)                # ds_3d/ds_ip

    # expansion height: z on the ray at the in-plane isocenter distance
    # (s = D_so); rows expand about their OWN u=0 height so the hat
    # matmuls stay (V, Nz) and the u-dependence rides the 1st-order term
    z0_vu = cz + sigma * D_so                        # (V, U) exact
    z0_v = z0_vu[:, n_det_u // 2]                    # (V,) central column
    zg = np.arange(Nz, dtype=np.float64)
    Wz = np.maximum(0.0, 1.0 - np.abs(z0_v[:, None] - zg[None]))
    # d/dz0 of the hat interp, with VIRTUAL ZERO slices beyond the slab
    # (matching map_coordinates' cval=0 decay) and a centered stencil when
    # the expansion point sits on a knot (the default pv puts every
    # detector row exactly on a slice, and the ray wanders BOTH sides)
    Wdz = np.zeros_like(Wz)
    for v, z0 in enumerate(z0_v):
        if z0 <= -1.0 or z0 >= Nz:
            continue
        k = int(np.floor(z0))
        if abs(z0 - round(z0)) < 1e-9:      # on a knot: centered diff
            k0 = int(round(z0))
            if 0 <= k0 - 1 < Nz:
                Wdz[v, k0 - 1] -= 0.5
            if 0 <= k0 + 1 < Nz:
                Wdz[v, k0 + 1] += 0.5
        else:                                # in a segment: its slope
            if 0 <= k < Nz:
                Wdz[v, k] -= 1.0
            if 0 <= k + 1 < Nz:
                Wdz[v, k + 1] += 1.0

    # fan-coordinate geometry for the moment transform: the (beta, u) ray
    # IS the parallel line (theta, s_par); its unit direction (pointing
    # away from the source) and the source's coordinate along it
    gamma = np.arctan2(u_det, L)                     # (U,)
    theta_q = ang[:, None] + gamma[None, :]          # (A, U)
    # in-plane frame matches ct._slice_radon_fan: source at
    # (r, c) = -D_so*(sin b, cos b); ray direction from source to cell
    src_r = -D_so * np.sin(ang)[:, None]             # (A, 1)
    src_c = -D_so * np.cos(ang)[:, None]
    dir_r = (float(geom.det_dist) * np.sin(ang)[:, None]
             + u_det[None, :] * np.cos(ang)[:, None]) - src_r
    dir_c = (float(geom.det_dist) * np.cos(ang)[:, None]
             - u_det[None, :] * np.sin(ang)[:, None]) - src_c
    inv = 1.0 / np.sqrt(dir_r ** 2 + dir_c ** 2)
    dir_r, dir_c = dir_r * inv, dir_c * inv          # (A, U) unit omega
    s_src = src_r * dir_r + src_c * dir_c            # source coord on line

    return {
        "thetas": thetas, "ds": ds, "n_s": n_s, "grid": grid,
        "pad": grid.pad,
        "Wz": Wz, "Wdz": Wdz, "sigma": sigma, "obliq": obliq,
        "z0_v": z0_v, "z0_vu": cz + sigma * D_so, "D_so": D_so,
        "dir_r": dir_r, "dir_c": dir_c, "s_src": s_src,
        "theta_q": theta_q,
    }


def _fdk_rebin_consts(ang: np.ndarray, geom, Nz: int, n_det_v: int,
                      n_det_u: int, N: int):
    """Host constants of the rebinning FDK (``fdk(method='spectral')``):
    express the cone->parallel DATA rebinning as dense matmuls so the
    analytic cone reconstruction is gather-free end-to-end.

    Construction (P-FDK, the standard industrial rebinning variant of
    Feldkamp — cf. the gather :func:`..ct.fdk`):

    1. de-obliquity weight ``wob = sqrt(L^2+u^2)/sqrt(L^2+u^2+v^2)``
       converts each 3D arc-length datum to its IN-PLANE fan line
       integral (``ds_ip/ds_3d``, the exact inverse of the forward
       SSRB obliquity);
    2. detector row v holds (approximately, SSRB) the fan sinogram of
       the slice at its isocenter height — the same z model as
       :func:`radon_cone_spectral`;
    3. each parallel line (theta_i, s_j) IS the measured fan ray at
       ``gamma = asin(s_j/D_so)``, ``beta = theta_i - gamma``,
       ``u = L tan(gamma)`` (or its conjugate ``beta + pi + 2 gamma``…
       with u mirrored — used when the primary beta falls outside the
       scan's angular coverage, which interleaves conjugate rays of a
       2-pi scan into a HALF-step [0, pi) parallel grid);
    4. slices read interpolated detector rows (``Wv``).

    Returns ``(wob (V,U), Wv (Nz,V), thetas (T,), Wu[c] (U,S),
    Wb[c] (T,S,A))`` with conjugate class c in {0,1}; queries without
    angular coverage get zero weights (unmeasured parallel lines)."""
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pu, pv = float(geom.spacing_u()), float(geom.spacing_v())
    A = ang.shape[0]
    V, U, S = n_det_v, n_det_u, n_det_u

    u_det = (np.arange(U) - (U - 1) / 2.0) * pu
    v_det = (np.arange(V) - (V - 1) / 2.0) * pv
    L_ip = np.sqrt(L ** 2 + u_det[None, :] ** 2)
    wob = L_ip / np.sqrt(L ** 2 + u_det[None, :] ** 2
                         + v_det[:, None] ** 2)        # (V, U) ds_ip/ds_3d

    # rows -> slices: slice z reads the row at its isocenter height
    # (inverse of the forward z_v map; out-of-panel slices get zero)
    cz = (Nz - 1) / 2.0
    v_of_z = (np.arange(Nz) - cz) * (L / D_so) / pv + (V - 1) / 2.0
    Wv = np.maximum(0.0, 1.0 - np.abs(v_of_z[:, None]
                                      - np.arange(V)[None, :]))  # (Nz, V)

    # parallel target grid: unit-pitch s, T = A thetas over [0, pi)
    # (a 2-pi scan's conjugate rays interleave to this half-step grid)
    T = A
    thetas = np.arange(T) * (np.pi / T)
    s_j = np.arange(S) - (S - 1) / 2.0
    sin_g = np.clip(s_j / D_so, -0.999, 0.999)
    gamma = np.arcsin(sin_g)                            # (S,)
    u_q = L * np.tan(gamma)                             # (S,) flat-panel u

    # u-interp matrices per conjugate class (u mirrored for class 1)
    def u_mat(sign):
        ui = np.clip(sign * u_q / pu + (U - 1) / 2.0, 0.0, U - 1.0)
        k = np.minimum(np.floor(ui).astype(np.int64), U - 2)
        f = ui - k
        W = np.zeros((U, S))
        np.add.at(W, (k, np.arange(S)), 1.0 - f)
        np.add.at(W, (k + 1, np.arange(S)), f)
        # kill queries whose |u| exceeds the panel (no extrapolation)
        W[:, np.abs(sign * u_q) > (U - 1) / 2.0 * pu + pu / 2] = 0.0
        return W

    Wu = [u_mat(+1.0), u_mat(-1.0)]

    # beta-interp: periodic bilinear on the SORTED concrete source angles;
    # a query only counts as covered if it lands in a gap <= 2.5x the
    # median (so partial scans route to the conjugate ray or to zero)
    order = np.argsort(np.mod(ang, 2 * np.pi))
    bs = np.mod(ang, 2 * np.pi)[order]                  # sorted (A,)
    gaps = np.diff(np.concatenate([bs, bs[:1] + 2 * np.pi]))
    max_gap = 2.5 * max(np.median(gaps), 1e-12)

    def beta_weights(bq):                               # (T, S) queries
        Wb = np.zeros((T, S, A))
        b = np.mod(bq, 2 * np.pi)
        k = np.searchsorted(bs, b, side="right") - 1    # in [-1, A-1]
        k = np.mod(k, A)
        k1 = np.mod(k + 1, A)
        b0 = bs[k]
        gap = np.mod(bs[k1] - b0, 2 * np.pi)
        gap = np.where(gap <= 1e-12, 2 * np.pi, gap)
        f = np.mod(b - b0, 2 * np.pi) / gap
        ok = (np.mod(b - b0, 2 * np.pi) <= gaps[k]) & (gaps[k] <= max_gap)
        ii, jj = np.nonzero(ok)
        np.add.at(Wb, (ii, jj, order[k[ok]]), 1.0 - f[ok])
        np.add.at(Wb, (ii, jj, order[k1[ok]]), f[ok])
        return Wb, ok

    bq0 = thetas[:, None] - gamma[None, :]              # primary ray
    bq1 = thetas[:, None] + np.pi + gamma[None, :]      # conjugate, u -> -u
    Wb0, ok0 = beta_weights(bq0)
    Wb1, ok1 = beta_weights(bq1)
    # where both rays are measured, average them (noise reduction and
    # exact symmetry); renormalize so covered queries sum to 1
    both = ok0 & ok1
    Wb0[both] *= 0.5
    Wb1[both] *= 0.5
    return wob, Wv, thetas, Wu, [Wb0, Wb1]


def fdk_spectral(sino, angles, geom, vol_shape,
                 filter_name: str = "ramp"):
    """Gather-free Feldkamp reconstruction by REBINNING (P-FDK): weight
    the cone data back to in-plane fan integrals, rebin to a parallel
    ``(Nz, M, T, S)`` sinogram with the host-built matmuls of
    :func:`_fdk_rebin_consts`, and run the spectral parallel FBP
    (:func:`..ct.fbp`) per slice.  Same layouts as the gather
    :func:`..ct.fdk` (sinogram ``(M, A, V, U)`` -> volume
    ``(Nz, M, N, N)``); ``angles`` must be concrete, shared or
    per-frame.  Agreement with the gather FDK is bounded by the shared
    SSRB z model plus the rebinning interpolation (measured in
    tests/test_ct_spectral.py); both converge to per-slice parallel FBP
    as ``source_dist -> inf``.  Intended as the production-scale cone
    warm start."""
    from .ct import fbp

    sino = jnp.asarray(sino)
    dt = sino.dtype
    real_dt = jnp.float64 if dt == jnp.float64 else jnp.float32
    M, A, V, U = sino.shape
    Nz, N = vol_shape[0], vol_shape[-1]
    ang = _concrete_angles(angles)
    if ang.ndim == 2:
        if ang.shape[0] != M:
            raise ValueError(
                f"per-frame angles must be (M={M}, n_angles), got "
                f"{ang.shape}"
            )
        frames = [
            fdk_spectral(sino[m:m + 1], ang[m], geom, vol_shape,
                         filter_name=filter_name)[:, 0]
            for m in range(M)
        ]
        return jnp.stack(frames, axis=1).astype(dt)

    key = ("fdk-rebin", ang.tobytes(), ang.shape, tuple(geom), Nz, V, U, N)
    wob, Wv, thetas, Wu, Wb = _host_memo(
        _GRID_CACHE, key,
        lambda: _fdk_rebin_consts(ang, geom, Nz, V, U, N))

    hi = jax.lax.Precision.HIGHEST
    d = sino.astype(real_dt) * jnp.asarray(wob, real_dt)[None, None]
    # rows -> slices first (V is small): (M, A, V, U) -> (Nz, M, A, U)
    dz = jnp.einsum("zv,mavu->zmau", jnp.asarray(Wv, real_dt), d,
                    precision=hi)
    par = 0.0
    for c in range(2):
        du = jnp.einsum("zmau,us->zmas", dz, jnp.asarray(Wu[c], real_dt),
                        precision=hi)
        par = par + jnp.einsum("tsa,zmas->zmts",
                               jnp.asarray(Wb[c], real_dt), du,
                               precision=hi)
    return fbp(par, thetas, n_out=N, filter_name=filter_name,
               method="spectral").astype(dt)


def _cone_spectral_shared(vol, ang: np.ndarray, geom, n_det_v: int,
                          n_det_u: int, angle_chunk, oversample: float,
                          order: int, precision, tables,
                          absolute: bool = False):
    """Shared-angle spectral cone forward: SSRB + optional first-order
    in-slope correction.  ``vol`` (Nz, M, N, N) -> (M, A, V, U).

    ``absolute=True`` applies the ABS-FACTOR SURROGATE instead: every
    signed geometry factor (``Wdz``, ``sigma``, ``sig0``, the moment
    direction/offset weights, the coordinate weights) is replaced by its
    absolute value and all terms combine with ``+`` — a linear operator
    whose entries bound ``|A|``'s factor-path sums (up to the spectral
    splat's ringing tails), so its row sums ``A_abs(1)`` / column sums
    ``A_abs^T(1)`` feed the Pock-Chambolle diagonal preconditioner that
    the SIGNED sums were measured to break."""
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    real_dt = (jnp.float64 if vol.dtype == jnp.float64 else jnp.float32)
    vol = vol.astype(real_dt)
    cc = _cone_host_consts(geom, ang, Nz, n_det_v, n_det_u, N, oversample)
    hi = jax.lax.Precision.HIGHEST
    mag = (jnp.abs if absolute else (lambda a: a))

    Ws, Wt = _rebin_mats(cc["grid"], real_dt)

    def fan_resample(dense):                          # (Nz, M, nT, nS)
        # bilinear resample at the fan coordinates as two matmuls
        # (gather-free, unlike map_coordinates)
        return _rebin_apply(dense, Ws, Wt, precision)  # (Nz, M, A, U)

    def dense_radon(v):
        d = _radon_spectral_shared(v, cc["thetas"], cc["n_s"],
                                   angle_chunk, det_spacing=cc["ds"],
                                   tables=tables, precision=precision)
        return _fold_pad(d, cc["pad"])

    Wz = jnp.asarray(cc["Wz"], real_dt)

    if order >= 1:
        # first moment along the ray about the source:  Mom[g](beta,u) =
        # integral s*g ds = R[<p,w>g] - (src.w)*R[g], with <p,w>g two
        # coordinate-weighted spectral radons (p = centered (r, c)).
        # The three dense radons share the NUDFT tables, so run them as
        # ONE call at 3x frame batch (M is a pure batch axis of the
        # spectral path): the table reads and per-pass fixed costs are
        # paid once instead of three times
        rr = jnp.asarray(np.arange(N, dtype=np.float64) - (N - 1) / 2.0,
                         real_dt)
        rw = mag(rr)
        stacked = jnp.concatenate(
            [vol, vol * rw[:, None], vol * rw[None, :]], axis=1)
        Fall = fan_resample(dense_radon(stacked))     # (Nz, 3M, A, U)
        F0, Fr, Fc = Fall[:, :M], Fall[:, M:2 * M], Fall[:, 2 * M:]
        out = jnp.einsum("vz,zmau->mavu", Wz, F0, precision=hi)
        dir_r = mag(jnp.asarray(cc["dir_r"], real_dt))  # (A, U)
        dir_c = mag(jnp.asarray(cc["dir_c"], real_dt))
        s_src = jnp.asarray(cc["s_src"], real_dt)
        Wdz = mag(jnp.asarray(cc["Wdz"], real_dt))
        sigma = mag(jnp.asarray(cc["sigma"], real_dt))  # (V, U)
        # f(cz + sigma*s) ~ f(z0_v) + (cz + sigma*s - z0_v) f'(z0_v)
        # with z0_v = cz + sigma(v, u_center)*D_so, so the coefficient is
        # sigma(v,u)*s - sigma(v,u0)*D_so:
        sig0 = jnp.asarray(
            np.broadcast_to(cc["z0_v"][:, None] - (Nz - 1) / 2.0,
                            cc["sigma"].shape), real_dt)  # sigma_v0 * D_so
        if absolute:
            # abs-factor surrogate, decomposed about the ISOCENTER
            # distance s = D_so instead of the source: the raw moment
            # carries a large cancelling D_so*F0 pair whose abs version
            # over-bounds |A| ~5-10x and was measured to cost the whole
            # preconditioning advantage.  sigma*Mom - sig0*F0 ==
            # sigma*Mom* + (sigma*D_so - sig0)*F0 with Mom* the moment
            # about s=D_so — both factors are wander-sized.
            D_so = float(cc["D_so"])
            MomS = (dir_r * Fr + dir_c * Fc
                    + jnp.abs(s_src + D_so) * F0)     # (Nz, M, A, U)
            G0 = jnp.einsum("vz,zmau->mavu", Wdz, F0, precision=hi)
            GM = jnp.einsum("vz,zmau->mavu", Wdz, MomS, precision=hi)
            coef0 = jnp.abs(sigma * D_so - jnp.abs(sig0))  # (V, U)
            out = out + sigma[None, None] * GM + coef0[None, None] * G0
        else:
            Mom = (dir_r * Fr + dir_c * Fc) - s_src * F0  # (Nz, M, A, U)
            G0 = jnp.einsum("vz,zmau->mavu", Wdz, F0, precision=hi)
            GM = jnp.einsum("vz,zmau->mavu", Wdz, Mom, precision=hi)
            out = out + sigma[None, None] * GM - sig0[None, None] * G0
    else:
        F0 = fan_resample(dense_radon(vol))           # (Nz, M, A, U)
        out = jnp.einsum("vz,zmau->mavu", Wz, F0, precision=hi)

    obliq = jnp.asarray(cc["obliq"], real_dt)         # (V, U)
    return out * obliq[None, None]


def radon_cone_spectral(vol, angles, geom, n_det_v: Optional[int] = None,
                        n_det_u: Optional[int] = None,
                        angle_chunk: Optional[int] = None,
                        oversample: float = 2.0, order: int = 1,
                        precision: Optional[str] = None, _tables=None,
                        z_kernel: str = "hat"):
    """Gather-free cone-beam forward projection: SINGLE-SLICE REBINNING
    (SSRB — detector row ``v`` reads the volume slice at its
    isocenter-plane height, a tiny ``(n_det_v, Nz)`` interpolation
    MATMUL, then the rebinned spectral fan path of
    :func:`radon_fan_spectral`) plus, at ``order=1`` (default), the
    first-order term of the expansion in the ray's z-slope: the in-plane
    FIRST-MOMENT fan transform, computed gather-free as two extra
    spectral radons of coordinate-weighted volumes
    (``R[r f], R[c f]`` — the moment of a line integral is a linear
    combination of these, the ray being ``z(s) = sigma s``), times the
    z-derivative interpolation stencil.  The exact per-cell obliquity
    weight ``ds_3d/ds_inplane`` matches :func:`..ct.radon_cone`'s 3D
    arc-length integration.  Same layouts as ``radon_cone``: volume
    ``(Nz, M, N, N)``, ``angles`` ``(n_angles,)`` shared or
    ``(M, n_angles)`` per-frame, sinogram ``(M, n_angles, n_det_v,
    n_det_u)``.

    Accuracy vs the gather cone: ``order=0`` is classic SSRB,
    O(sigma) — measured 5.4%/2.7%/1.5% rel at D_so = 2N/4N/8N on a
    smooth thin-slab phantom (Nz=8, N=64); ``order=1`` cancels the
    linear term, leaving O(sigma^2 f'') (see
    ``tests/test_ct_spectral.py`` for the recorded values).  Exact in
    the parallel limit.  The operator is LINEAR with an exact vjp
    adjoint at every order, so primal-dual solvers see a consistent
    pair.  Cost: ``order=1`` runs 3 dense spectral radons instead of 1
    (same NUDFT tables — hoistable via the ``prepare()/apply``
    protocol of :func:`make_cone_spectral_projector`).

    ``order=2`` is the z-DFT OFFSET-LINE tier (the certifiable rung): z-DFT the padded slab, evaluate each complex
    slab's spectrum on lines offset along the ray direction by the
    per-ray frequency ``nu_k sigma(v, u)`` (the modulated line integral
    IS the Fourier-slice value at the offset line,
    :func:`_modulated_bucket`), Lagrange-interpolated over per-slab
    Chebyshev offset nodes.  No Taylor expansion in the slope — the
    knot-crossing limit of order=1 disappears — and sigma's u-dependence
    is exact; the remaining model difference vs the gather cone is the
    z-interpolation KERNEL: ``z_kernel='hat'`` (default) weights slab k
    by the hat spectrum ``sinc^2(nu_k/2)`` (the gather cone's linear
    z-interp, truncated to the first spectral replica — only z-Nyquist
    content differs), ``'trig'`` keeps the band-limited interpolant.
    Cost: ``sum_k L_k`` complex dense radons (L_k Chebyshev nodes,
    growing with ``nu_k * sigma_max * N`` = the ray's z-wander in
    radians) — measured ~10-40x order=1 depending on cone angle; use as
    the accuracy-certification tier, not the iteration workhorse.
    ``angle_chunk`` and the ``prepare()/apply`` table protocol apply to
    orders 0/1 only (the z-DFT tier builds its per-node tables in-trace
    inside its own memoized jitted runner).
    """
    vol = jnp.asarray(vol)
    if vol.ndim != 4 or vol.shape[-2] != vol.shape[-1]:
        raise ValueError(
            f"radon_cone_spectral expects a square-plane rank-4 "
            f"(Nz, M, N, N) volume, got {tuple(vol.shape)}"
        )
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N
    ang = _concrete_angles(angles)
    if order not in (0, 1, 2):
        raise ValueError(f"order must be 0, 1 or 2, got {order!r}")

    def shared(v, a, tab):
        if order == 2:
            # route through a memoized jitted runner: the tier's tables
            # are complex transcendentals, built once by a compiled
            # program (as the NUDFT table builds are)
            run = _zdft_runner(a.tobytes(), a.shape, tuple(geom),
                               n_det_v, n_det_u, float(oversample),
                               precision, z_kernel)
            return run(v)
        return _cone_spectral_shared(v, a, geom, n_det_v, n_det_u,
                                     angle_chunk, oversample, order,
                                     precision, tab)

    if ang.ndim == 2:
        if ang.shape[0] != M:
            raise ValueError(
                f"per-frame angles must be (M={M}, n_angles), got "
                f"{ang.shape}"
            )
        frames = [
            shared(vol[:, m:m + 1], ang[m],
                   _tables[m] if _tables else None)[0]
            for m in range(M)
        ]
        return jnp.stack(frames, axis=0).astype(vol.dtype)
    return shared(vol, ang, _tables).astype(vol.dtype)


def make_cone_spectral_projector(vol_shape, angles, geom,
                                 n_det_v: Optional[int] = None,
                                 n_det_u: Optional[int] = None,
                                 dtype=jnp.float32,
                                 angle_chunk: Optional[int] = None,
                                 oversample: float = 2.0, order: int = 1,
                                 precision: Optional[str] = None,
                                 z_kernel: str = "hat"):
    """``(A, A_T)`` for a fixed cone-beam geometry on the SSRB spectral
    path (:func:`radon_cone_spectral`); ``A_T`` is the exact transpose of
    the (approximate-but-linear) map, so the CP/SART solvers see a
    consistent operator pair.  Same ``prepare()/apply`` table-hoisting
    protocol as the parallel/fan spectral projectors."""
    ang = _concrete_angles(angles)
    Nz, N = vol_shape[0], vol_shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N
    real_dt = (jnp.float64 if jnp.dtype(dtype) == jnp.float64
               else jnp.float32)

    from .ct import FanBeamGeometry

    fan = FanBeamGeometry(source_dist=geom.source_dist,
                          det_dist=geom.det_dist,
                          det_spacing=geom.spacing_u())

    def A(x):
        return radon_cone_spectral(x, ang, geom, n_det_v=n_det_v,
                                   n_det_u=n_det_u,
                                   angle_chunk=angle_chunk,
                                   oversample=oversample, order=order,
                                   precision=precision, z_kernel=z_kernel)

    def A_T(y):
        _, vjp = jax.vjp(A, jnp.zeros(tuple(vol_shape), dtype))
        (x_bar,) = vjp(y)
        return x_bar

    def apply(consts, x):
        return radon_cone_spectral(x, ang, geom, n_det_v=n_det_v,
                                   n_det_u=n_det_u,
                                   angle_chunk=angle_chunk,
                                   oversample=oversample, order=order,
                                   precision=precision, _tables=consts,
                                   z_kernel=z_kernel)

    if order != 2:
        # the z-DFT tier builds its (per-slab, per-offset-node) tables
        # in-trace — no hoistable NUDFT consts to thread; solvers fall
        # back to the lazy closure
        _attach_fan_tables(A, apply, ang, fan, n_det_u, N, oversample,
                           real_dt)
    return A, A_T


# ---------------------------------------------------------------------------
# The z-DFT offset-line cone tier (order=2): exact-in-z-band cone operator
# ---------------------------------------------------------------------------


def _natural_spectrum(F, Np: int, real_dt):
    """Reorder an fft-bin-ordered last axis to natural frequencies
    ``k = -Np/2 .. +Np/2`` (Np+1 entries): the +Nyquist column REUSES the
    -Nyquist FFT bin (identical for integer-grid images) and both ends
    get weight 1/2 (trapezoid) — without the symmetrization the unpaired
    Nyquist term leaks a spurious imaginary part that the later
    ``Re[phase * M]`` combination would fold into the cone value."""
    Fn = jnp.roll(F, Np // 2, axis=-1)
    Fn = jnp.concatenate([Fn, Fn[..., :1]], axis=-1)
    nu = jnp.asarray(
        2.0 * np.pi * (np.arange(Np + 1) - Np // 2) / Np, real_dt)
    w = np.ones(Np + 1)
    w[0] = w[-1] = 0.5
    return Fn, nu, jnp.asarray(w, real_dt)


def _modulated_bucket(img_c, ang_b, vertical: bool, n_det: int, Np: int,
                      det_spacing, delta, precision):
    """MODULATED spectral projection of one regime bucket: the complex
    image's transform evaluated on the OFFSET line
    ``xi(lam) = lam * omega_perp - delta * omega`` (the Fourier transform
    of ``s -> integral f(s omega_perp + t omega) e^{i delta t} dt``), then
    synthesized at the detector.  The offset rides ENTIRELY in the
    per-angle NUDFT/synthesis tables: one frequency component stays on
    the padded FFT grid by solving ``lam_k`` per bin, so the expensive
    image-side transform is still shared by every angle in the bucket.
    ``img_c`` is complex (..., N, N) (a z-DFT slab — no conjugate
    symmetry, so the FULL spectrum is used, ~2x the folded real path);
    ``delta`` may be a traced scalar (tables build in-trace, which lets
    ``lax.map`` scan the offset nodes without exploding the program).
    Returns complex (..., A, n_det)."""
    N = img_c.shape[-1]
    c0 = (N - 1) / 2.0
    real_dt = (jnp.float64 if img_c.dtype == jnp.complex128
               else jnp.float32)
    th = jnp.asarray(ang_b, real_dt)
    sin, cos = jnp.sin(th), jnp.cos(th)                 # (A,)
    s_j = (jnp.arange(n_det, dtype=real_dt) - (n_det - 1) / 2.0) \
        * jnp.asarray(det_spacing, real_dt)
    x = jnp.arange(N, dtype=real_dt) - c0
    delta = jnp.asarray(delta, real_dt)
    if vertical:
        # column FFT holds xi_col = nu_k:  -lam sin - delta cos = nu
        F = jnp.fft.fft(img_c, n=Np, axis=-1)           # (..., r, k)
        F, nu, w = _natural_spectrum(F, Np, real_dt)
        lam = -(nu[None, :] + delta * cos[:, None]) / sin[:, None]
        xi = lam * cos[:, None] - delta * sin[:, None]  # row frequency
        den = jnp.abs(sin)
    else:
        # row FFT holds xi_row = nu_k:  lam cos - delta sin = nu
        F = jnp.moveaxis(jnp.fft.fft(img_c, n=Np, axis=-2), -2, -1)
        F, nu, w = _natural_spectrum(F, Np, real_dt)
        lam = (nu[None, :] + delta * sin[:, None]) / cos[:, None]
        xi = -lam * sin[:, None] - delta * cos[:, None]  # col frequency
        den = jnp.abs(cos)
    # slice NUDFT over the non-grid axis: P[a, x, k] = e^{-i xi x}
    P = jnp.exp(-1j * xi[:, None, :] * x[None, :, None])
    G = jnp.einsum("...rk,ark->...ak", F, P.astype(F.dtype),
                   precision=precision)
    # synthesis with the padded-FFT centering phase e^{+i nu c0}
    E = (w[None, :, None] * jnp.exp(
        1j * (lam[:, :, None] * s_j[None, None, :]
              + (nu * c0)[None, :, None]))) \
        / (Np * den)[:, None, None]
    return jnp.einsum("...ak,aks->...as", G, E.astype(F.dtype),
                      precision=precision)


def _modulated_dense(slabs_c, thetas: np.ndarray, n_s: int, ds, delta,
                     precision):
    """Modulated dense radon over a concrete theta grid, both regimes,
    statically un-permuted like :func:`_radon_spectral_shared`.
    ``slabs_c`` complex (..., N, N) -> complex (..., n_theta, n_s)."""
    N = slabs_c.shape[-1]
    Np = 2 * N
    idx_v, idx_h = _regime_split(thetas)
    parts = []
    if idx_v.size:
        parts.append(_modulated_bucket(slabs_c, thetas[idx_v], True, n_s,
                                       Np, ds, delta, precision))
    if idx_h.size:
        parts.append(_modulated_bucket(slabs_c, thetas[idx_h], False, n_s,
                                       Np, ds, delta, precision))
    out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-2)
    order = np.concatenate([idx_v, idx_h])
    if not np.array_equal(order, np.arange(thetas.shape[0])):
        inv = np.argsort(order)
        out = jnp.concatenate(
            [out[..., int(i):int(i) + 1, :] for i in inv], axis=-2)
    return out


def _lagrange_matrix(nodes: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Exact Lagrange interpolation weights from ``nodes`` (L,) to query
    points ``q`` (Q,): returns (Q, L) with ``f(q) = W @ f(nodes)`` exact
    for polynomials of degree < L."""
    L = len(nodes)
    W = np.ones((len(q), L))
    for l in range(L):
        for j in range(L):
            if j != l:
                W[:, l] *= (q - nodes[j]) / (nodes[l] - nodes[j])
    return W


def _zdft_host_consts(geom, ang: np.ndarray, Nz: int, n_det_v: int,
                      n_det_u: int, N: int, oversample: float,
                      z_kernel: str):
    """Concrete constants of the z-DFT offset-line cone tier (order=2):
    the padded z period, per-slab frequencies/kernel weights, and per-slab
    Chebyshev offset-node sets with Lagrange matrices mapping node values
    to every ray's exact offset ``nu_k * sigma(v, u)``."""
    cc = _cone_host_consts(geom, ang, Nz, n_det_v, n_det_u, N, oversample)
    sigma = cc["sigma"]                                 # (V, U) signed
    t_ext = 0.75 * N + 1.0
    smax = float(np.abs(cc["s_src"]).max())
    sigmax = float(np.abs(sigma).max())
    exc = sigmax * (t_ext + smax)
    # periodized z model: need Nzp > max |z - m| + 1 so no ray inside the
    # in-plane support reads a periodic replica of the slab
    Nzp = int(np.ceil((Nz - 1) / 2.0 + exc)) + 3
    Nzp = max(Nzp, Nz + 2)
    Nzp += Nzp % 2
    Kz = Nzp // 2
    nus = 2.0 * np.pi * np.arange(Kz + 1) / Nzp
    wsym = np.full(Kz + 1, 2.0)
    wsym[0] = 1.0
    wsym[Kz] = 1.0                                      # Nzp is even
    if z_kernel == "hat":
        # first-replica hat spectrum: matches the gather cone's LINEAR
        # z interpolation for content below the z Nyquist (the replica
        # truncation only affects z-Nyquist content; 'trig' keeps the
        # band-limited Dirichlet interpolant instead)
        kern = np.sinc(nus / (2.0 * np.pi)) ** 2
    elif z_kernel == "trig":
        kern = np.ones_like(nus)
    else:
        raise ValueError(
            f"unknown z_kernel {z_kernel!r}; expected 'hat' or 'trig'")

    q = sigma.ravel()                                   # (V*U,)
    nodes, Wq_pos, Wq_neg = [], [], []
    for k, nu in enumerate(nus):
        D = nu * sigmax
        # Chebyshev interpolation of e^{i delta t} on |delta| <= D,
        # |t| <= t_ext: error ~ (e D t_ext / (2 n))^n — convergence needs
        # n > (e/2) D t_ext ~ 1.36 D t_ext BEFORE the decay starts (an
        # 0.75x undercount looked fine at N=64 but left the N=256
        # production probe 3x WORSE than order=1)
        n = max(1, int(np.ceil(1.45 * D * t_ext)) + 6) if D > 0 else 1
        if n == 1:
            nd = np.zeros(1)
            Wp = np.ones((q.size, 1))
            Wn = Wp
        else:
            nd = D * np.cos(np.pi * (2 * np.arange(n) + 1) / (2 * n))
            Wp = _lagrange_matrix(nd, nu * q)
            Wn = _lagrange_matrix(nd, -nu * q)
        nodes.append(nd)
        Wq_pos.append(Wp.reshape(n_det_v, n_det_u, n))
        Wq_neg.append(Wn.reshape(n_det_v, n_det_u, n))
    return {"cc": cc, "Nzp": Nzp, "Kz": Kz, "nus": nus, "wsym": wsym,
            "kern": kern, "nodes": nodes, "Wq_pos": Wq_pos,
            "Wq_neg": Wq_neg}


def _rebin_apply_parity(dense, Ws, Wt, parity: int, precision):
    """One fold-parity half of :func:`_rebin_apply` (complex-safe): the
    z-DFT tier must route parity-1 queries (theta folded by pi, ray
    direction NEGATED) to the OPPOSITE modulation offset, so the two
    parity slots interpolate over different node stacks."""
    precision = precision or _DEFAULT_PRECISION
    U = Wt.shape[1]
    n_s = Ws.shape[0]
    Wsp = jnp.asarray(np.asarray(Ws).reshape(n_s, U, 2)[..., parity])
    Wtp = jnp.asarray(np.asarray(Wt)[..., parity])      # (A, U, T)
    d2 = jnp.einsum("...ts,su->...tu", dense, Wsp.astype(dense.dtype),
                    precision=precision)
    return jnp.einsum("aut,...tu->...au", Wtp.astype(dense.dtype), d2,
                      precision=precision)


@functools.lru_cache(maxsize=16)
def _zdft_runner(ang_bytes: bytes, ang_shape, geom_tuple, n_det_v: int,
                 n_det_u: int, oversample: float, precision,
                 z_kernel: str):
    """Memoized jitted entry of the order=2 tier (one executable per
    geometry; repeated calls and solver loops reuse it)."""
    from .ct import ConeBeamGeometry

    ang = np.frombuffer(ang_bytes, np.float64).reshape(ang_shape)
    geom = ConeBeamGeometry(*geom_tuple)

    @jax.jit
    def run(v):
        return _cone_spectral_zdft_shared(v, ang, geom, n_det_v, n_det_u,
                                          oversample, precision, z_kernel)

    return run


def _cone_spectral_zdft_shared(vol, ang: np.ndarray, geom, n_det_v: int,
                               n_det_u: int, oversample: float, precision,
                               z_kernel: str):
    """Shared-angle z-DFT offset-line cone forward (order=2): exact (to
    interpolation-free spectral precision) for z-band-limited content at
    ARBITRARY cone angle — no Taylor expansion in the ray slope, exact
    u-dependence of sigma.  ``vol`` (Nz, M, N, N) -> (M, A, V, U)."""
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    real_dt = (jnp.float64 if vol.dtype == jnp.float64 else jnp.float32)
    cdt = jnp.complex128 if real_dt == jnp.float64 else jnp.complex64
    vol = vol.astype(real_dt)
    zc = _zdft_host_consts(geom, ang, Nz, n_det_v, n_det_u, N, oversample,
                           z_kernel)
    cc = zc["cc"]
    grid = cc["grid"]
    Ws, Wt = _rebin_mats(grid, real_dt)
    cz = (Nz - 1) / 2.0
    hi = jax.lax.Precision.HIGHEST
    precision = precision or _DEFAULT_PRECISION

    # z-DFT slabs: (Kz+1, M, N, N) complex.  The slab-DFT matrix is
    # built in-trace from real phases
    m_idx = np.arange(Nz)
    ph = jnp.asarray(zc["nus"][:, None] * m_idx[None, :], real_dt)
    Wslab = (jnp.cos(ph) - 1j * jnp.sin(ph)).astype(cdt)
    slabs = jnp.einsum("kz,zmab->kmab", Wslab, vol.astype(cdt),
                       precision=hi)

    sigma = jnp.asarray(cc["sigma"], real_dt)           # (V, U)
    s_src = jnp.asarray(cc["s_src"], real_dt)           # (A, U)
    obliq = jnp.asarray(cc["obliq"], real_dt)
    thetas, ds, n_s, pad = cc["thetas"], cc["ds"], cc["n_s"], cc["pad"]

    out = jnp.zeros((M, ang.shape[0], n_det_v, n_det_u), real_dt)
    for k in range(zc["Kz"] + 1):
        nu = float(zc["nus"][k])
        nd = zc["nodes"][k]                             # (L,) offsets
        slab_k = slabs[k]                               # (M, N, N)

        def one_node(delta, slab_k=slab_k):
            return _modulated_dense(slab_k, thetas, n_s, ds, delta,
                                    precision)

        if len(nd) == 1:
            denseL = one_node(jnp.asarray(nd[0], real_dt))[None]
        else:
            denseL = jax.lax.map(one_node, jnp.asarray(nd, real_dt))
        # fold pad: the wrap column is the MIRROR node's s-flip
        # (R_delta(theta+pi, s) = R_{-delta}(theta, -s); Chebyshev node
        # sets are symmetric, node l <-> node L-1-l)
        if pad:
            wrap = jnp.flip(jnp.flip(denseL, axis=0)[..., :pad, :],
                            axis=-1)
            denseL = jnp.concatenate([denseL, wrap], axis=-2)
        reb0 = _rebin_apply_parity(denseL, Ws, Wt, 0, precision)
        reb1 = _rebin_apply_parity(denseL, Ws, Wt, 1, precision)
        Wp = jnp.asarray(zc["Wq_pos"][k], real_dt).astype(cdt)
        Wn = jnp.asarray(zc["Wq_neg"][k], real_dt).astype(cdt)
        val = (jnp.einsum("vul,lmau->mavu", Wp, reb0, precision=hi)
               + jnp.einsum("vul,lmau->mavu", Wn, reb1, precision=hi))
        phase = jnp.exp(1j * nu * (cz - sigma[None, :, :]
                                   * s_src[:, None, :])).astype(cdt)
        term = jnp.real(phase[None] * val)
        out = out + (zc["wsym"][k] * zc["kern"][k] / zc["Nzp"]) \
            * term.astype(real_dt)
    return out * obliq[None, None]


def cone_spectral_precond_sums(vol_shape, angles, geom,
                               n_det_v: Optional[int] = None,
                               n_det_u: Optional[int] = None,
                               dtype=jnp.float32,
                               oversample: float = 2.0, order: int = 1,
                               precision: Optional[str] = None):
    """Pock-Chambolle diagonal inputs for the spectral cone: ``(row_sum (M,A,V,U), col_sum (Nz,M,N,N))`` from the
    ABS-FACTOR SURROGATE operator (``_cone_spectral_shared(absolute=
    True)``) — every signed geometry factor replaced by its absolute
    value, so sums bound the factor-path mass of ``|A|`` (the SIGNED sums
    ``A(1)``/``A^T(1)`` stay positive here but underestimate ``|A|`` and
    the preconditioned solve was measured to diverge at production
    scale).  The surrogate is linear, so the column sums are its exact
    vjp at ones.  The spectral splat's ringing tails are not bounded by
    the surrogate — callers must validate the preconditioned step
    condition with a power method and rescale (``models.ct`` does, with
    the measured norm recorded in the solve's guidance)."""
    ang = _concrete_angles(angles)
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N

    def A_abs(x):
        if ang.ndim == 2:
            frames = [
                _cone_spectral_shared(
                    x[:, m:m + 1], ang[m], geom, n_det_v, n_det_u, None,
                    oversample, order, precision, None, absolute=True)[0]
                for m in range(M)
            ]
            return jnp.stack(frames, axis=0)
        return _cone_spectral_shared(x, ang, geom, n_det_v, n_det_u, None,
                                     oversample, order, precision, None,
                                     absolute=True)

    @jax.jit
    def sums():
        ones_v = jnp.ones(tuple(vol_shape), dtype)
        row = A_abs(ones_v)
        _, vjp = jax.vjp(A_abs, jnp.zeros(tuple(vol_shape), dtype))
        (col,) = vjp(jnp.ones_like(row))
        # the surrogate's ringing can dip epsilon-negative; the
        # preconditioner needs strictly positive diagonals
        eps = 1e-6
        return (jnp.maximum(row, eps * jnp.max(row)),
                jnp.maximum(col, eps * jnp.max(col)))

    return sums()
