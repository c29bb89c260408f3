"""Shared collision math: moments, sponge, wall model, WALE, regularized BGK.

Layout-agnostic core used by both the block-sparse path (ops.stream_collide)
and the dense-patch path (ops.dense_step).  Operates on flat (27, N) streamed
distributions + six (3, N) face-neighbor velocity fields.

Physics per the reference kernel (reference: src/physics_kernels.jl:152-354):
moments with a 0.01 density floor, sponge blending toward freestream, the
equilibrium log-law wall-stress body force, WALE eddy viscosity from central
difference velocity gradients, and regularized-BGK collision with Guo forcing.
Direction-space contractions are phrased as matmuls (moments, Pi tensor,
regularized reconstruction) at HIGHEST precision — the momentum sums cancel
heavily and bf16-class matmul accumulation visibly corrupts u.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import lattice as lat

KAPPA = 0.41

_C = jnp.asarray(lat.C)  # (3, 27)
_W = jnp.asarray(lat.W)  # (27,)
_CX = jnp.asarray(lat.C_X.astype(np.float32))
_PI_MAT = jnp.asarray(lat.PI_MAT)
_REG_MAT = jnp.asarray(lat.REG_MAT)
_OPP = lat.OPP

_HI = jax.lax.Precision.HIGHEST


def inlet_equilibrium(k_cx, w_k, u):
    """Axis-aligned (x-flow) equilibrium used for inlet/outlet/sponge targets
    (reference: src/physics_kernels.jl:99-113)."""
    cu = k_cx * u
    return w_k * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * u * u)


def hash_noise(gy, gz, t_seed, salt=1234):
    """Integer-hash turbulence noise in [-1, 1), bit-exact with the reference
    (reference: src/physics_utils.jl:17-28)."""
    combined = (
        gy * np.int32(374761393)
        + gz * np.int32(668265263)
        + t_seed * np.int32(1274126177)
        + np.int32(salt)
    )
    h = combined.astype(jnp.uint32)
    h = (h ^ (h >> 16)) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> 13)) * np.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    # the masked value fits in 16 bits, so the float conversion goes via
    # int32
    low = (h & np.uint32(0xFFFF)).astype(jnp.int32)
    return low.astype(jnp.float32) / 32768.0 - 1.0


def collide(
    f_str: jnp.ndarray,  # (27, N) post-streaming distributions
    vel_nbrs: Tuple[jnp.ndarray, ...],  # 6x (3, N): E, W, N, S, T, B neighbors
    obstacle: jnp.ndarray,  # (N,) bool
    sponge: jnp.ndarray,  # (N,)
    wall_dist: jnp.ndarray,  # (N,)
    u_inlet,
    *,
    tau: float,
    c_wale: float,
    nu_sgs_background: float,
    wall_model: bool,
    sponge_blend: bool,
):
    """Returns (f_out, rho_out, vel_out) flat."""
    # obstacle bounce-back reads the raw streamed values (the reference's
    # obstacle branch precedes sponge blending)
    f_bb = f_str[_OPP]

    # Direction-space contractions as explicit broadcast+reduce: exact f32
    # accumulation (the momentum sums cancel heavily) and cheaper than
    # matrix products with K=27.
    rho_raw = jnp.maximum(jnp.sum(f_str, axis=0), 0.01)
    jmom = jnp.sum(_C[:, :, None] * f_str[None, :, :], axis=1)
    inv_rho_raw = 1.0 / rho_raw
    u = jmom * inv_rho_raw

    one_m = 1.0 - sponge
    rho = rho_raw * one_m + sponge  # target rho = 1
    u = jnp.stack(
        [u[0] * one_m + u_inlet * sponge, u[1] * one_m, u[2] * one_m]
    )
    if sponge_blend:
        feq_target = inlet_equilibrium(_CX, _W, u_inlet)  # (27,)
        f_str = f_str * one_m[None, :] + feq_target[:, None] * sponge[None, :]

    if wall_model:
        wd = wall_dist
        u_mag = jnp.sqrt(jnp.sum(u * u, axis=0))
        nu_visc = (tau - 0.5) / 3.0
        u_tau = (
            u_mag
            * (nu_visc / (wd * u_mag + 1e-10)) ** (1.0 / 7.0)
            * (2.0 * 8.3) ** (-1.0 / 7.0)
        )
        u_tau = jnp.maximum(u_tau, 1e-6)
        y_p = u_tau * wd / nu_visc
        u_plus_law = (1.0 / KAPPA) * jnp.log(jnp.maximum(y_p, 1e-10)) + 5.2
        corr = jnp.where(
            (y_p > 11.81) & (u_plus_law > 0.1),
            (u_mag / u_tau) / jnp.maximum(u_plus_law, 0.1),
            1.0,
        )
        u_tau = jnp.maximum(u_tau * corr, 1e-6)
        tau_wall = rho * u_tau * u_tau
        tau_res = rho * nu_visc * u_mag / jnp.maximum(wd, 1e-10)
        active = (
            (wd > 0.0)
            & (wd < 10.0)
            & (u_mag > 1e-6)
            & (tau_wall > tau_res)
            & (nu_visc > 1e-10)
        )
        force_mag = jnp.where(active, (tau_wall - tau_res) / jnp.maximum(wd, 1e-10), 0.0)
        F = -force_mag[None, :] * u / jnp.maximum(u_mag, 1e-20)[None, :]
        u_eq = u + 0.5 * F * inv_rho_raw[None, :]
    else:
        F = None
        u_eq = u
    usq_eq = jnp.sum(u_eq * u_eq, axis=0)

    # WALE eddy viscosity from central differences of the previous step's
    # velocity field (reference: src/physics_kernels.jl:251-301)
    vE, vW, vN, vS, vT, vB = vel_nbrs
    gx = 0.5 * (vE - vW)  # d(ux,uy,uz)/dx
    gy = 0.5 * (vN - vS)
    gz = 0.5 * (vT - vB)
    g11, g12, g13 = gx[0], gy[0], gz[0]
    g21, g22, g23 = gx[1], gy[1], gz[1]
    g31, g32, g33 = gx[2], gy[2], gz[2]

    gsq11 = g11 * g11 + g12 * g21 + g13 * g31
    gsq12 = g11 * g12 + g12 * g22 + g13 * g32
    gsq13 = g11 * g13 + g12 * g23 + g13 * g33
    gsq21 = g21 * g11 + g22 * g21 + g23 * g31
    gsq22 = g21 * g12 + g22 * g22 + g23 * g32
    gsq23 = g21 * g13 + g22 * g23 + g23 * g33
    gsq31 = g31 * g11 + g32 * g21 + g33 * g31
    gsq32 = g31 * g12 + g32 * g22 + g33 * g32
    gsq33 = g31 * g13 + g32 * g23 + g33 * g33

    tr_term = (gsq11 + gsq22 + gsq33) / 3.0
    Sd11, Sd22, Sd33 = gsq11 - tr_term, gsq22 - tr_term, gsq33 - tr_term
    Sd12 = 0.5 * (gsq12 + gsq21)
    Sd13 = 0.5 * (gsq13 + gsq31)
    Sd23 = 0.5 * (gsq23 + gsq32)
    S12 = 0.5 * (g12 + g21)
    S13 = 0.5 * (g13 + g31)
    S23 = 0.5 * (g23 + g32)

    OP1 = Sd11**2 + Sd22**2 + Sd33**2 + 2.0 * (Sd12**2 + Sd13**2 + Sd23**2)
    OP2 = g11**2 + g22**2 + g33**2 + 2.0 * (S12**2 + S13**2 + S23**2)
    OP1_32 = OP1 * jnp.sqrt(OP1)
    OP2_52 = OP2 * OP2 * jnp.sqrt(jnp.maximum(OP2, 1e-12))
    denom = OP2_52 + OP1 * jnp.sqrt(jnp.sqrt(jnp.maximum(OP1, 1e-12)))
    nu_eddy = jnp.where(
        (OP1 > 1e-12) & (denom > 1e-12),
        (c_wale * c_wale) * OP1_32 / jnp.maximum(denom, 1e-12),
        0.0,
    )
    nu_eddy = jnp.maximum(nu_eddy, nu_sgs_background)
    omega = 1.0 / jnp.maximum(tau + nu_eddy * 3.0, 0.500001)

    cu = jnp.sum(_C.T[:, :, None] * u_eq[None, :, :], axis=1)  # (27, N)
    feq = rho[None, :] * _W[:, None] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq_eq)
    f_neq = f_str - feq
    pi6 = jnp.sum(_PI_MAT[:, :, None] * f_neq[None, :, :], axis=1)  # (6, N)
    f_neq_reg = jnp.sum(_REG_MAT[:, :, None] * pi6[None, :, :], axis=1)  # (27, N)

    f_coll = feq + (1.0 - omega)[None, :] * f_neq_reg
    if F is not None:
        cF = jnp.sum(_C.T[:, :, None] * F[None, :, :], axis=1)
        uF = jnp.sum(u * F, axis=0)  # post-sponge u, like the reference
        ft = 3.0 * _W[:, None] * (cF * (1.0 + 3.0 * cu) - uF[None, :])
        f_coll = f_coll + (1.0 - 0.5 * omega)[None, :] * ft

    f_out = jnp.where(obstacle[None, :], f_bb, f_coll)
    rho_out = jnp.where(obstacle, 1.0, rho)
    vel_out = jnp.where(obstacle[None, :], 0.0, u)
    return f_out, rho_out, vel_out


def _wale_omega(vel_nbrs, tau, c_wale, nu_sgs_background):
    """WALE eddy viscosity -> relaxation rate omega, from 6 face-neighbor
    velocity stacks (reference: src/physics_kernels.jl:251-301)."""
    vE, vW_, vN, vS_, vT, vB = vel_nbrs
    g11, g12, g13 = 0.5 * (vE[0] - vW_[0]), 0.5 * (vN[0] - vS_[0]), 0.5 * (vT[0] - vB[0])
    g21, g22, g23 = 0.5 * (vE[1] - vW_[1]), 0.5 * (vN[1] - vS_[1]), 0.5 * (vT[1] - vB[1])
    g31, g32, g33 = 0.5 * (vE[2] - vW_[2]), 0.5 * (vN[2] - vS_[2]), 0.5 * (vT[2] - vB[2])

    gsq11 = g11 * g11 + g12 * g21 + g13 * g31
    gsq12 = g11 * g12 + g12 * g22 + g13 * g32
    gsq13 = g11 * g13 + g12 * g23 + g13 * g33
    gsq21 = g21 * g11 + g22 * g21 + g23 * g31
    gsq22 = g21 * g12 + g22 * g22 + g23 * g32
    gsq23 = g21 * g13 + g22 * g23 + g23 * g33
    gsq31 = g31 * g11 + g32 * g21 + g33 * g31
    gsq32 = g31 * g12 + g32 * g22 + g33 * g32
    gsq33 = g31 * g13 + g32 * g23 + g33 * g33

    tr_term = (gsq11 + gsq22 + gsq33) / 3.0
    Sd11, Sd22, Sd33 = gsq11 - tr_term, gsq22 - tr_term, gsq33 - tr_term
    Sd12 = 0.5 * (gsq12 + gsq21)
    Sd13 = 0.5 * (gsq13 + gsq31)
    Sd23 = 0.5 * (gsq23 + gsq32)
    S12 = 0.5 * (g12 + g21)
    S13 = 0.5 * (g13 + g31)
    S23 = 0.5 * (g23 + g32)

    OP1 = Sd11**2 + Sd22**2 + Sd33**2 + 2.0 * (Sd12**2 + Sd13**2 + Sd23**2)
    OP2 = g11**2 + g22**2 + g33**2 + 2.0 * (S12**2 + S13**2 + S23**2)
    OP1_32 = OP1 * jnp.sqrt(OP1)
    OP2_52 = OP2 * OP2 * jnp.sqrt(jnp.maximum(OP2, 1e-12))
    denom = OP2_52 + OP1 * jnp.sqrt(jnp.sqrt(jnp.maximum(OP1, 1e-12)))
    nu_eddy = jnp.where(
        (OP1 > 1e-12) & (denom > 1e-12),
        (c_wale * c_wale) * OP1_32 / jnp.maximum(denom, 1e-12),
        0.0,
    )
    nu_eddy = jnp.maximum(nu_eddy, nu_sgs_background)
    return 1.0 / jnp.maximum(tau + nu_eddy * 3.0, 0.500001)


def _wall_force(ux, uy, uz, rho, wall_dist, tau):
    """Equilibrium log-law wall-stress body force (reference:
    src/physics_kernels.jl:206-241)."""
    wd = wall_dist
    u_mag = jnp.sqrt(ux * ux + uy * uy + uz * uz)
    nu_visc = (tau - 0.5) / 3.0
    u_tau = (
        u_mag
        * (nu_visc / (wd * u_mag + 1e-10)) ** (1.0 / 7.0)
        * (2.0 * 8.3) ** (-1.0 / 7.0)
    )
    u_tau = jnp.maximum(u_tau, 1e-6)
    y_p = u_tau * wd / nu_visc
    u_plus_law = (1.0 / KAPPA) * jnp.log(jnp.maximum(y_p, 1e-10)) + 5.2
    corr = jnp.where(
        (y_p > 11.81) & (u_plus_law > 0.1),
        (u_mag / u_tau) / jnp.maximum(u_plus_law, 0.1),
        1.0,
    )
    u_tau = jnp.maximum(u_tau * corr, 1e-6)
    tau_wall = rho * u_tau * u_tau
    tau_res = rho * nu_visc * u_mag / jnp.maximum(wd, 1e-10)
    active = (
        (wd > 0.0) & (wd < 10.0) & (u_mag > 1e-6)
        & (tau_wall > tau_res) & (nu_visc > 1e-10)
    )
    fm = jnp.where(active, (tau_wall - tau_res) / jnp.maximum(wd, 1e-10), 0.0)
    inv_umag = 1.0 / jnp.maximum(u_mag, 1e-20)
    return -fm * ux * inv_umag, -fm * uy * inv_umag, -fm * uz * inv_umag


def collide_unrolled_v2(
    f_list,  # list of 27 arrays, any common shape S (post-streaming)
    vel_nbrs,  # 6 stacks (3, *S): E, W, N, S, T, B
    obstacle,  # (*S,) bool
    sponge,
    wall_dist,
    u_inlet,
    *,
    tau: float,
    c_wale: float,
    nu_sgs_background: float,
    wall_model: bool,
    sponge_blend: bool,
    g_shifted: bool = False,
):
    """collide_unrolled with the direction loops factorized over the D3Q27
    tensor-product structure — same physics, ~2x fewer vector ops:

      - forward moments via per-(cy,cz)-column partial sums (x first):
        all 10 moments (rho, j, raw 2nd moments S) in ~90 adds;
      - Pi_neq analytically: Pi_neq = S(f~) - rho (u_eq u_eq^T + cs^2 I)
        (the discrete 2nd moment of the 2nd-order equilibrium is exact),
        so no per-direction feq/f_neq pass exists at all;
      - output as a quadratic form in c: f_k/w_k = t0 + c.t1 + c^T T2 c
        where the ten t-fields absorb equilibrium + regularized stress +
        Guo forcing, evaluated with 3
        shared terms per (cy,cz) column.

    With `g_shifted`, inputs AND outputs are the shifted distributions
    g_k = f_k - w_k (ops.storage bf16 g-storage): the weight shift is exact
    on the moment side (sum w = 1, sum c w = 0, sum c c^T w = cs^2 I) and on
    the output side f_k = w_k * expr_k means g_k = w_k * (expr_k - 1) — five
    constant adds replace the 54 per-direction decode/encode ops a step on
    g-storage otherwise spends.  Obstacle bounce-back and the mirror BCs commute with
    the shift (w[opp_k] = w[mirror_k] = w[k]).

    Validated against collide_unrolled (test_collide_moments).
    Returns (f_out list of 27, rho_out, vel_out (3, *S)).
    """
    f_out, rho_out, (ux, uy, uz) = collide_fields(
        f_list, vel_nbrs, obstacle, sponge, wall_dist, u_inlet, tau=tau,
        c_wale=c_wale, nu_sgs_background=nu_sgs_background,
        wall_model=wall_model, sponge_blend=sponge_blend, g_shifted=g_shifted,
    )
    return f_out, rho_out, jnp.stack([ux, uy, uz])


def collide_fields(
    f_list, vel_nbrs, obstacle, sponge, wall_dist, u_inlet, *,
    tau: float, c_wale: float, nu_sgs_background: float, wall_model: bool,
    sponge_blend: bool, g_shifted: bool = False,
):
    """collide_unrolled_v2 with the velocity returned as three separate
    fields (ux, uy, uz) instead of one stacked array, so that every value it
    builds has the shape of its inputs (what a GPU kernel body needs)."""
    W = [float(w) for w in lat.W64]

    def col(cy, cz):
        return (0 + 1) + 3 * (cy + 1) + 9 * (cz + 1)

    # --- forward: column partials then cross-column reductions ---
    s0 = {}
    s1 = {}
    s2 = {}
    for cz in (-1, 0, 1):
        for cy in (-1, 0, 1):
            km = col(cy, cz)
            fm, f0, fp = f_list[km - 1], f_list[km], f_list[km + 1]
            s0[cy, cz] = fm + f0 + fp
            s1[cy, cz] = fp - fm
            s2[cy, cz] = fp + fm

    def red(d, coef):
        acc = None
        for key, v in d.items():
            c = coef(*key)
            if c == 0:
                continue
            term = v if c == 1 else -v
            acc = term if acc is None else acc + term
        return acc

    rho_raw = red(s0, lambda cy, cz: 1)
    jx = red(s1, lambda cy, cz: 1)
    jy = red(s0, lambda cy, cz: cy)
    jz = red(s0, lambda cy, cz: cz)
    Sxx = red(s2, lambda cy, cz: 1)
    Syy = red(s0, lambda cy, cz: cy * cy)
    Szz = red(s0, lambda cy, cz: cz * cz)
    Sxy = red(s1, lambda cy, cz: cy)
    Szx = red(s1, lambda cy, cz: cz)
    Syz = red(s0, lambda cy, cz: cy * cz)

    if g_shifted:
        # moments of the weight shift: sum w = 1, sum c w = 0,
        # sum c c^T w = cs^2 I (j and the cross moments are shift-free)
        rho_raw = rho_raw + 1.0
        CS2_ = 1.0 / 3.0
        Sxx = Sxx + CS2_
        Syy = Syy + CS2_
        Szz = Szz + CS2_

    rho_raw = jnp.maximum(rho_raw, 0.01)
    inv_rho_raw = 1.0 / rho_raw
    ux, uy, uz = jx * inv_rho_raw, jy * inv_rho_raw, jz * inv_rho_raw

    one_m = 1.0 - sponge
    rho = rho_raw * one_m + sponge
    ux = ux * one_m + u_inlet * sponge
    uy = uy * one_m
    uz = uz * one_m

    if sponge_blend:
        # Pi(feq at rho=1, u=(u_in,0,0)) = u u^T + cs^2 I (exact identity)
        s = sponge
        Sxx = Sxx * one_m + (u_inlet * u_inlet + 1.0 / 3.0) * s
        Syy = Syy * one_m + (1.0 / 3.0) * s
        Szz = Szz * one_m + (1.0 / 3.0) * s
        Sxy = Sxy * one_m
        Syz = Syz * one_m
        Szx = Szx * one_m

    if wall_model:
        Fx, Fy, Fz = _wall_force(ux, uy, uz, rho, wall_dist, tau)
        ux_eq = ux + 0.5 * Fx * inv_rho_raw
        uy_eq = uy + 0.5 * Fy * inv_rho_raw
        uz_eq = uz + 0.5 * Fz * inv_rho_raw
    else:
        Fx = Fy = Fz = None
        ux_eq, uy_eq, uz_eq = ux, uy, uz
    usq_eq = ux_eq * ux_eq + uy_eq * uy_eq + uz_eq * uz_eq

    omega = _wale_omega(vel_nbrs, tau, c_wale, nu_sgs_background)
    one_m_om = 1.0 - omega

    # Pi_neq = S(f~) - rho (u_eq u_eq^T + cs^2 I), pre-scaled by (1 - omega)
    CS2 = 1.0 / 3.0
    rux, ruy, ruz = rho * ux_eq, rho * uy_eq, rho * uz_eq
    ruxx, ruyy, ruzz = rux * ux_eq, ruy * uy_eq, ruz * uz_eq
    ruxy, ruyz, ruzx = rux * uy_eq, ruy * uz_eq, ruz * ux_eq
    rho_cs2 = rho * CS2
    P1 = one_m_om * (Sxx - ruxx - rho_cs2)
    P2 = one_m_om * (Syy - ruyy - rho_cs2)
    P3 = one_m_om * (Szz - ruzz - rho_cs2)
    P4 = one_m_om * (Sxy - ruxy)
    P5 = one_m_om * (Syz - ruyz)
    P6 = one_m_om * (Szx - ruzx)

    # quadratic-form fields: f_k / w_k = t0 + c.t + c^T T2 c
    # (the -4.5*cs^2*tr(P) constant from the regularized Q_k folds into t0;
    # in g-space the output is g_k = w_k (expr_k - 1), one constant fold)
    t0 = rho - 1.5 * rho * usq_eq - 1.5 * (P1 + P2 + P3)
    if g_shifted:
        t0 = t0 - 1.0
    tx, ty, tz = 3.0 * rux, 3.0 * ruy, 3.0 * ruz
    txx = 4.5 * (ruxx + P1)
    tyy = 4.5 * (ruyy + P2)
    tzz = 4.5 * (ruzz + P3)
    txy = 9.0 * (ruxy + P4)
    tyz = 9.0 * (ruyz + P5)
    tzx = 9.0 * (ruzx + P6)
    if wall_model:
        guo = 1.0 - 0.5 * omega
        Gx, Gy, Gz = guo * Fx, guo * Fy, guo * Fz
        # uF uses the post-sponge u, like the reference (physics_kernels.jl:348)
        t0 = t0 - 3.0 * guo * (ux * Fx + uy * Fy + uz * Fz)
        tx = tx + 3.0 * Gx
        ty = ty + 3.0 * Gy
        tz = tz + 3.0 * Gz
        txx = txx + 9.0 * Gx * ux_eq
        tyy = tyy + 9.0 * Gy * uy_eq
        tzz = tzz + 9.0 * Gz * uz_eq
        txy = txy + 9.0 * (Gx * uy_eq + Gy * ux_eq)
        tyz = tyz + 9.0 * (Gy * uz_eq + Gz * uy_eq)
        tzx = tzx + 9.0 * (Gz * ux_eq + Gx * uz_eq)

    f_out = [None] * 27
    for cz in (-1, 0, 1):
        for cy in (-1, 0, 1):
            km = col(cy, cz)
            base = t0
            if cy:
                base = base + (ty if cy == 1 else -ty) + tyy
            if cz:
                base = base + (tz if cz == 1 else -tz) + tzz
            if cy and cz:
                base = base + (tyz if cy * cz == 1 else -tyz)
            xlin = tx
            if cy:
                xlin = xlin + (txy if cy == 1 else -txy)
            if cz:
                xlin = xlin + (tzx if cz == 1 else -tzx)
            bx = base + txx
            f_out[km] = W[km] * base
            f_out[km + 1] = W[km + 1] * (bx + xlin)
            f_out[km - 1] = W[km - 1] * (bx - xlin)

    # obstacle cells: full bounce-back of the raw streamed values
    # (reference: src/physics_kernels.jl:154-166)
    for k in range(27):
        f_out[k] = jnp.where(obstacle, f_list[int(lat.OPP[k])], f_out[k])
    rho_out = jnp.where(obstacle, 1.0, rho)
    vel_out = tuple(jnp.where(obstacle, 0.0, u) for u in (ux, uy, uz))
    return f_out, rho_out, vel_out


def collide_unrolled(
    f_list,  # list of 27 arrays, any common shape S (post-streaming)
    vel_nbrs,  # 6 tuples/stacks (3, *S): E, W, N, S, T, B
    obstacle,  # (*S,) bool
    sponge,
    wall_dist,
    u_inlet,
    *,
    tau: float,
    c_wale: float,
    nu_sgs_background: float,
    wall_model: bool,
    sponge_blend: bool,
):
    """Same physics as collide() but unrolled over the 27 directions with no
    (27, N) stacking: per-k arrays stay register-resident under fusion, and
    the direction-space contractions become 27-term scalar-weighted sums.

    Returns (f_out_list, rho_out, vel_out(3, *S))."""
    W = [float(w) for w in lat.W64]
    CXi = [int(c) for c in lat.C_X]
    CYi = [int(c) for c in lat.C_Y]
    CZi = [int(c) for c in lat.C_Z]

    def wsum(coeffs):
        acc = None
        for k in range(27):
            c = coeffs[k]
            if c == 0:
                continue
            term = f_list[k] if c == 1 else (-f_list[k] if c == -1 else c * f_list[k])
            acc = term if acc is None else acc + term
        return acc

    # raw streamed values for the obstacle bounce-back (pre-sponge-blend,
    # like the reference's obstacle branch)
    f_raw = f_list

    rho_raw = jnp.maximum(wsum([1.0] * 27), 0.01)
    jx = wsum(CXi)
    jy = wsum(CYi)
    jz = wsum(CZi)
    inv_rho_raw = 1.0 / rho_raw
    ux, uy, uz = jx * inv_rho_raw, jy * inv_rho_raw, jz * inv_rho_raw

    one_m = 1.0 - sponge
    rho = rho_raw * one_m + sponge
    ux = ux * one_m + u_inlet * sponge
    uy = uy * one_m
    uz = uz * one_m
    if sponge_blend:
        fl = []
        for k in range(27):
            cu_t = CXi[k] * u_inlet
            feq_t = W[k] * (1.0 + 3.0 * cu_t + 4.5 * cu_t * cu_t - 1.5 * u_inlet * u_inlet)
            fl.append(f_list[k] * one_m + feq_t * sponge)
        f_list = fl

    if wall_model:
        wd = wall_dist
        u_mag = jnp.sqrt(ux * ux + uy * uy + uz * uz)
        nu_visc = (tau - 0.5) / 3.0
        u_tau = (
            u_mag
            * (nu_visc / (wd * u_mag + 1e-10)) ** (1.0 / 7.0)
            * (2.0 * 8.3) ** (-1.0 / 7.0)
        )
        u_tau = jnp.maximum(u_tau, 1e-6)
        y_p = u_tau * wd / nu_visc
        u_plus_law = (1.0 / KAPPA) * jnp.log(jnp.maximum(y_p, 1e-10)) + 5.2
        corr = jnp.where(
            (y_p > 11.81) & (u_plus_law > 0.1),
            (u_mag / u_tau) / jnp.maximum(u_plus_law, 0.1),
            1.0,
        )
        u_tau = jnp.maximum(u_tau * corr, 1e-6)
        tau_wall = rho * u_tau * u_tau
        tau_res = rho * nu_visc * u_mag / jnp.maximum(wd, 1e-10)
        active = (
            (wd > 0.0) & (wd < 10.0) & (u_mag > 1e-6)
            & (tau_wall > tau_res) & (nu_visc > 1e-10)
        )
        fm = jnp.where(active, (tau_wall - tau_res) / jnp.maximum(wd, 1e-10), 0.0)
        inv_umag = 1.0 / jnp.maximum(u_mag, 1e-20)
        Fx, Fy, Fz = -fm * ux * inv_umag, -fm * uy * inv_umag, -fm * uz * inv_umag
        ux_eq = ux + 0.5 * Fx * inv_rho_raw
        uy_eq = uy + 0.5 * Fy * inv_rho_raw
        uz_eq = uz + 0.5 * Fz * inv_rho_raw
    else:
        Fx = Fy = Fz = None
        ux_eq, uy_eq, uz_eq = ux, uy, uz
    usq_eq = ux_eq * ux_eq + uy_eq * uy_eq + uz_eq * uz_eq

    vE, vW_, vN, vS_, vT, vB = vel_nbrs
    g11, g12, g13 = 0.5 * (vE[0] - vW_[0]), 0.5 * (vN[0] - vS_[0]), 0.5 * (vT[0] - vB[0])
    g21, g22, g23 = 0.5 * (vE[1] - vW_[1]), 0.5 * (vN[1] - vS_[1]), 0.5 * (vT[1] - vB[1])
    g31, g32, g33 = 0.5 * (vE[2] - vW_[2]), 0.5 * (vN[2] - vS_[2]), 0.5 * (vT[2] - vB[2])

    gsq11 = g11 * g11 + g12 * g21 + g13 * g31
    gsq12 = g11 * g12 + g12 * g22 + g13 * g32
    gsq13 = g11 * g13 + g12 * g23 + g13 * g33
    gsq21 = g21 * g11 + g22 * g21 + g23 * g31
    gsq22 = g21 * g12 + g22 * g22 + g23 * g32
    gsq23 = g21 * g13 + g22 * g23 + g23 * g33
    gsq31 = g31 * g11 + g32 * g21 + g33 * g31
    gsq32 = g31 * g12 + g32 * g22 + g33 * g32
    gsq33 = g31 * g13 + g32 * g23 + g33 * g33

    tr_term = (gsq11 + gsq22 + gsq33) / 3.0
    Sd11, Sd22, Sd33 = gsq11 - tr_term, gsq22 - tr_term, gsq33 - tr_term
    Sd12 = 0.5 * (gsq12 + gsq21)
    Sd13 = 0.5 * (gsq13 + gsq31)
    Sd23 = 0.5 * (gsq23 + gsq32)
    S12 = 0.5 * (g12 + g21)
    S13 = 0.5 * (g13 + g31)
    S23 = 0.5 * (g23 + g32)

    OP1 = Sd11**2 + Sd22**2 + Sd33**2 + 2.0 * (Sd12**2 + Sd13**2 + Sd23**2)
    OP2 = g11**2 + g22**2 + g33**2 + 2.0 * (S12**2 + S13**2 + S23**2)
    OP1_32 = OP1 * jnp.sqrt(OP1)
    OP2_52 = OP2 * OP2 * jnp.sqrt(jnp.maximum(OP2, 1e-12))
    denom = OP2_52 + OP1 * jnp.sqrt(jnp.sqrt(jnp.maximum(OP1, 1e-12)))
    nu_eddy = jnp.where(
        (OP1 > 1e-12) & (denom > 1e-12),
        (c_wale * c_wale) * OP1_32 / jnp.maximum(denom, 1e-12),
        0.0,
    )
    nu_eddy = jnp.maximum(nu_eddy, nu_sgs_background)
    omega = 1.0 / jnp.maximum(tau + nu_eddy * 3.0, 0.500001)

    # pass 2: equilibrium + non-equilibrium stress accumulation
    feq_list = []
    Pi_xx = Pi_yy = Pi_zz = Pi_xy = Pi_yz = Pi_zx = None
    for k in range(27):
        cx, cy, cz = CXi[k], CYi[k], CZi[k]
        cu = cx * ux_eq + cy * uy_eq + cz * uz_eq if (cx or cy or cz) else 0.0
        feq = rho * W[k] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq_eq) \
            if (cx or cy or cz) else rho * W[k] * (1.0 - 1.5 * usq_eq)
        feq_list.append(feq)
        fneq = f_list[k] - feq

        def acc(a, term):
            return term if a is None else a + term

        if cx * cx:
            Pi_xx = acc(Pi_xx, fneq)
        if cy * cy:
            Pi_yy = acc(Pi_yy, fneq)
        if cz * cz:
            Pi_zz = acc(Pi_zz, fneq)
        if cx * cy:
            Pi_xy = acc(Pi_xy, fneq if cx * cy == 1 else -fneq)
        if cy * cz:
            Pi_yz = acc(Pi_yz, fneq if cy * cz == 1 else -fneq)
        if cz * cx:
            Pi_zx = acc(Pi_zx, fneq if cz * cx == 1 else -fneq)

    one_m_om = 1.0 - omega
    if Fx is not None:
        guo = 1.0 - 0.5 * omega
        uF = ux * Fx + uy * Fy + uz * Fz

    CS2 = 1.0 / 3.0
    f_out = []
    rho_out = jnp.where(obstacle, 1.0, rho)
    vel_out = jnp.stack(
        [
            jnp.where(obstacle, 0.0, ux),
            jnp.where(obstacle, 0.0, uy),
            jnp.where(obstacle, 0.0, uz),
        ]
    )
    for k in range(27):
        cx, cy, cz = CXi[k], CYi[k], CZi[k]
        q = (cx * cx - CS2) * Pi_xx + (cy * cy - CS2) * Pi_yy + (cz * cz - CS2) * Pi_zz
        if cx * cy:
            q = q + 2.0 * cx * cy * Pi_xy
        if cy * cz:
            q = q + 2.0 * cy * cz * Pi_yz
        if cz * cx:
            q = q + 2.0 * cz * cx * Pi_zx
        freg = W[k] * 4.5 * q
        fc = feq_list[k] + one_m_om * freg
        if Fx is not None:
            cu = cx * ux_eq + cy * uy_eq + cz * uz_eq
            cF = cx * Fx + cy * Fy + cz * Fz
            ft = 3.0 * W[k] * (cF * (1.0 + 3.0 * cu) - uF)
            fc = fc + guo * ft
        # obstacle cells: full bounce-back of the raw (pre-sponge-blend)
        # streamed value, reference: src/physics_kernels.jl:154-166
        f_out.append(jnp.where(obstacle, f_raw[int(lat.OPP[k])], fc))
    return f_out, rho_out, vel_out
