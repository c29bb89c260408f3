"""D3Q27 lattice constants and moment matrices.

Rebuild of the reference lattice definition
(reference: src/lattice.jl:13-71, src/physics_v2.jl:99-117).

Direction ordering matches the reference: k = (cx+1) + 3*(cy+1) + 9*(cz+1)
with (cx, cy, cz) in {-1, 0, 1}^3, i.e. cx varies fastest.  The same encoding
is used for block-neighbor direction indices, so one table serves both.

Weights by |c|^2: 8/27 (0), 2/27 (1), 1/54 (2), 1/216 (3); cs^2 = 1/3.

Everything here is a small constant numpy array; device copies are created
lazily by the ops that need them.  In addition to the raw tables we provide
the contraction matrices used to phrase moments / regularized collision as
matmuls (matrix-unit friendly) instead of per-direction scalar loops.
"""

from __future__ import annotations

import numpy as np

Q = 27
CS2 = 1.0 / 3.0
CS4 = CS2 * CS2

# --- velocity set -----------------------------------------------------------


def _build():
    cx = np.zeros(Q, np.int32)
    cy = np.zeros(Q, np.int32)
    cz = np.zeros(Q, np.int32)
    w = np.zeros(Q, np.float64)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k = (dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)
                cx[k], cy[k], cz[k] = dx, dy, dz
                d2 = dx * dx + dy * dy + dz * dz
                w[k] = (8 / 27, 2 / 27, 1 / 54, 1 / 216)[d2]
    opp = np.zeros(Q, np.int32)
    mirror_y = np.zeros(Q, np.int32)
    mirror_z = np.zeros(Q, np.int32)
    for i in range(Q):
        opp[i] = (-cx[i] + 1) + 3 * (-cy[i] + 1) + 9 * (-cz[i] + 1)
        mirror_y[i] = (cx[i] + 1) + 3 * (-cy[i] + 1) + 9 * (cz[i] + 1)
        mirror_z[i] = (cx[i] + 1) + 3 * (cy[i] + 1) + 9 * (-cz[i] + 1)
    return cx, cy, cz, w, opp, mirror_y, mirror_z


C_X, C_Y, C_Z, W64, OPP, MIRROR_Y, MIRROR_Z = _build()
W = W64.astype(np.float32)

# (3, 27) float32 matrix of lattice velocities, for c·u style contractions.
C = np.stack([C_X, C_Y, C_Z]).astype(np.float32)

# --- moment contraction matrices -------------------------------------------
# Second-moment basis for the non-equilibrium stress tensor Pi.
# Order of the 6 independent components: xx, yy, zz, xy, yz, zx
# Pi_ab = sum_k f_neq_k c_ka c_kb   ->   Pi = PI_MAT @ f_neq  with PI_MAT (6, 27)
PI_MAT = np.stack(
    [
        C_X * C_X,
        C_Y * C_Y,
        C_Z * C_Z,
        C_X * C_Y,
        C_Y * C_Z,
        C_Z * C_X,
    ]
).astype(np.float32)

# Regularized reconstruction: f_neq_reg_k = w_k * 4.5 * (Pi : Q_k) where
# Q_k = c_k c_k - cs^2 I for the diagonal and plain c_ka c_kb off-diagonal
# with a factor 2 (reference: src/physics_kernels.jl:339-346).
# REG_MAT (27, 6) so that f_neq_reg = REG_MAT @ Pi6.
REG_MAT = (
    4.5
    * W64[:, None]
    * np.stack(
        [
            C_X * C_X - CS2,
            C_Y * C_Y - CS2,
            C_Z * C_Z - CS2,
            2.0 * C_X * C_Y,
            2.0 * C_Y * C_Z,
            2.0 * C_Z * C_X,
        ],
        axis=1,
    )
).astype(np.float32)

# Flat-cell roll offset inside an 8^3 block for pull streaming.
# Local flat index = z*64 + y*8 + x; source cell = (x-cx, y-cy, z-cz), so
# streamed[k][flat] = f[k][flat - OFF[k]] = roll(f[k], OFF[k]).
BLOCK_EDGE = 8
BLOCK_CELLS = BLOCK_EDGE**3
OFF = (C_Z * BLOCK_EDGE * BLOCK_EDGE + C_Y * BLOCK_EDGE + C_X).astype(np.int32)


def equilibrium_np(rho, ux, uy, uz):
    """Second-order Maxwell-Boltzmann equilibrium, numpy reference.

    Shapes: rho/ux/uy/uz broadcastable; returns (..., 27).
    (reference: src/physics_utils.jl:34-39)
    """
    rho = np.asarray(rho, np.float64)[..., None]
    cu = (
        np.asarray(ux, np.float64)[..., None] * C_X
        + np.asarray(uy, np.float64)[..., None] * C_Y
        + np.asarray(uz, np.float64)[..., None] * C_Z
    )
    usq = (
        np.asarray(ux, np.float64) ** 2
        + np.asarray(uy, np.float64) ** 2
        + np.asarray(uz, np.float64) ** 2
    )[..., None]
    return rho * W64 * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
