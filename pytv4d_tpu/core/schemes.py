"""Declarative stencil tables: the single source of truth for all four TV schemes.

The reference (eboigne/PyTV-4D) hand-unrolls 24 functions — 4 schemes x {D, D_T, tv}
x {CPU, GPU} (``pytv/tv_operators_CPU.py:76-658``, ``pytv/tv_CPU.py:47-333``).  Every
one of those functions is generated here from a small table: a scheme is an ordered
tuple of *channels*, each channel a one-dimensional finite difference along one axis
of the ``(Nz, M, N_row, N_col)`` volume, of one of three kinds:

- ``FWD``  : d[i] = f[i+1] - f[i],   stored at slot i,   valid i in [0, L-2]
- ``BWD``  : d[i] = f[i]   - f[i-1], stored at slot i,   valid i in [1, L-1]
- ``CTR``  : d[i] = f[i+1] - f[i-1], stored at slot i,   valid i in [1, L-2]

Slots outside the valid range are zero (the reference's one-sided boundary
convention, ``pytv/tv_operators_CPU.py:115-127`` and the math notebook's
"extended by 1 on both ends ... r_{N-1}=0, r_{-1}=0").

Deriving everything from this table guarantees D/D_T adjointness *by construction*
(D_T is the transposed scatter of the same table) and makes the sharded halo
path and the plain jnp path consume identical semantics.

Channel order, per-axis sqrt weights, and global normalization match the reference
exactly (parity targets in SURVEY.md section 2.2/2.3):

- upwind   : [ROW fwd, COL fwd, (Z fwd), (T fwd)]            norm 1
  (``tv_operators_CPU.py:222-286``)
- downwind : [ROW bwd, COL bwd, (Z bwd), (T bwd)]            norm 1
  (``tv_operators_CPU.py:156-220``)
- central  : [ROW ctr, COL ctr, (Z ctr), (T ctr)]            norm 1/2
  with the reference's small-axis fallback: Z uses fwd when Nz==2, T uses fwd
  when M==2 (``tv_operators_CPU.py:339-348``, ``README.md:236``)
- hybrid   : [ROW fwd, COL fwd, ROW bwd, COL bwd,
              (Z fwd, Z bwd), (T fwd, T bwd)]                norm 1/sqrt(2)
  (``tv_operators_CPU.py:76-154``)

Gating: the Z channel(s) exist iff ``Nz > 1 and reg_z_over_reg > 0``
(``tv_operators_CPU.py:111``); the T channel(s) iff ``reg_time > 0 and M > 1``
(``tv_operators_CPU.py:113``).  Known reference defect fixed here by design
(SURVEY.md section 2.4.1): the reference CPU ``D_central`` gates the z channel
*count* on ``Nz > 2`` but fills it for ``Nz > 1``, crashing at Nz == 2; its GPU
version gates on ``Nz > 1`` and works.  We use the working ``Nz > 1`` gate with
the fwd fallback on both paths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Axes of the canonical (Nz, M, N_row, N_col) volume layout (``README.md:206,235``).
AXIS_Z = 0
AXIS_T = 1
AXIS_ROW = 2
AXIS_COL = 3

# Channel kinds.
FWD = "fwd"
BWD = "bwd"
CTR = "ctr"

SCHEMES = ("upwind", "downwind", "central", "hybrid")


@dataclasses.dataclass(frozen=True)
class Channel:
    """One finite-difference channel of a scheme.

    axis   : array axis of (Nz, M, N_row, N_col) the difference runs along
    kind   : FWD / BWD / CTR
    weight : '' (unit), 'z' (sqrt(reg_z_over_reg)) or 't' (sqrt(reg_time));
             't' channels additionally take the static-mask factor
             (``tv_operators_CPU.py:133,143,148-151``)
    """

    axis: int
    kind: str
    weight: str = ""


def _nan_to_zero(value: float) -> float:
    # The reference *intends* to zero a NaN reg (``tv_operators_CPU.py:100``:
    # ``if reg_z_over_reg == np.nan`` — always False).  Implement the intent.
    try:
        if math.isnan(value):
            return 0.0
    except TypeError:
        pass
    return value


def scheme_channels(
    scheme: str,
    Nz: int,
    M: int,
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
) -> Tuple[Tuple[Channel, ...], float]:
    """Return (ordered channels, global normalization) for a scheme instance.

    The channel tuple length is the reference's ``Nd``
    (``tv_operators_CPU.py:110-114,190-194,256-260,322-326``); the normalization
    is the trailing scalar the reference applies to D, D_T and G
    (hybrid: 1/sqrt(2), ``:154,448``; central: 1/2, ``:358,658``).
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")

    reg_z_over_reg = _nan_to_zero(reg_z_over_reg)
    z_on = Nz > 1 and reg_z_over_reg > 0
    t_on = reg_time > 0 and M > 1

    if scheme == "upwind":
        chans = [Channel(AXIS_ROW, FWD), Channel(AXIS_COL, FWD)]
        if z_on:
            chans.append(Channel(AXIS_Z, FWD, "z"))
        if t_on:
            chans.append(Channel(AXIS_T, FWD, "t"))
        return tuple(chans), 1.0

    if scheme == "downwind":
        chans = [Channel(AXIS_ROW, BWD), Channel(AXIS_COL, BWD)]
        if z_on:
            chans.append(Channel(AXIS_Z, BWD, "z"))
        if t_on:
            chans.append(Channel(AXIS_T, BWD, "t"))
        return tuple(chans), 1.0

    if scheme == "central":
        chans = [Channel(AXIS_ROW, CTR), Channel(AXIS_COL, CTR)]
        if z_on:
            # Small-axis fallback: upwind along z when Nz == 2
            # (``tv_operators_CPU.py:339-340``, GPU gate ``tv_operators_GPU.py:508``).
            chans.append(Channel(AXIS_Z, FWD if Nz == 2 else CTR, "z"))
        if t_on:
            # Same fallback along time when M == 2 (``tv_operators_CPU.py:347-348``).
            chans.append(Channel(AXIS_T, FWD if M == 2 else CTR, "t"))
        return tuple(chans), 0.5

    # hybrid: forward AND backward differences per active axis
    # (``tv_operators_CPU.py:117-152``).
    chans = [
        Channel(AXIS_ROW, FWD),
        Channel(AXIS_COL, FWD),
        Channel(AXIS_ROW, BWD),
        Channel(AXIS_COL, BWD),
    ]
    if z_on:
        chans.append(Channel(AXIS_Z, FWD, "z"))
        chans.append(Channel(AXIS_Z, BWD, "z"))
    if t_on:
        chans.append(Channel(AXIS_T, FWD, "t"))
        chans.append(Channel(AXIS_T, BWD, "t"))
    return tuple(chans), 1.0 / math.sqrt(2.0)


def num_channels(
    scheme: str, Nz: int, M: int, reg_z_over_reg: float = 1.0, reg_time: float = 0.0
) -> int:
    """The reference's ``Nd`` for a scheme instance."""
    chans, _ = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    return len(chans)


def channel_weight(channel: Channel, reg_z_over_reg: float, reg_time: float) -> float:
    """The sqrt pre-scaling the reference bakes into each emitted channel
    (``tv_operators_CPU.py:106-108,133,143``)."""
    if channel.weight == "z":
        return math.sqrt(_nan_to_zero(reg_z_over_reg))
    if channel.weight == "t":
        return math.sqrt(reg_time)
    return 1.0


def operator_norm_bound_sq(
    scheme: str, Nz: int, M: int, reg_z_over_reg: float = 1.0, reg_time: float = 0.0
) -> float:
    """Upper bound on ||D||_2^2, used for default primal-dual step sizes.

    Each 1D two-tap difference has operator norm <= 2 (norm^2 <= 4), so
    ||D||^2 <= normalization^2 * sum_c 4 * weight_c^2.  For the hybrid scheme on
    a single (N, N) frame this gives (1/2) * 4 * 4 = 8, the constant the
    reference's Chambolle-Pock recipe uses in ``tau = 1/(8+1)``
    (``README.md:141-143``).
    """
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    total = 0.0
    for ch in chans:
        w = channel_weight(ch, reg_z_over_reg, reg_time)
        total += 4.0 * w * w
    return norm * norm * total
