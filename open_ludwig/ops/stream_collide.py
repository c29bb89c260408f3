"""Fused D3Q27 stream + BC + WALE + wall model + regularized-BGK collide.

Functional JAX re-expression of the reference's single fused GPU kernel
(reference: src/physics_kernels.jl:9-358).  One call advances one level by one
sub-step:

  1. pull streaming  = per-direction roll on the flat 512-cell block axis,
     then one static-index scatter patching every cell whose source crossed a
     block boundary (neighbor gather / inlet / outlet / mirror / coarse-parent
     interpolation / w_k fallback — precompiled in core.plan.StreamPlan);
  2. moments, sponge blending, wall-model body force, WALE eddy viscosity from
     central-difference velocity gradients (previous step's velocity field);
  3. regularized-BGK collision with Guo-style forcing, phrased as small
     matmul contractions over the 27-direction axis (matrix-unit friendly) instead of
     scalar loops.

Obstacle cells take the full bounce-back path (f_out_k = f_streamed_opp(k),
rho = 1, u = 0).  The returned f_out is the post-collision field that the
Bouzidi correction consumes (no separate f_post buffer needed: the correction
is a functional scatter that reads the uncorrected snapshot).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import lattice as lat

KAPPA = 0.41

# device-side lattice constants (created once per process)
_C = jnp.asarray(lat.C)  # (3, 27) f32
_W = jnp.asarray(lat.W)  # (27,) f32
_CX = jnp.asarray(lat.C_X.astype(np.float32))
_PI_MAT = jnp.asarray(lat.PI_MAT)  # (6, 27)
_REG_MAT = jnp.asarray(lat.REG_MAT)  # (27, 6)
_OPP = lat.OPP  # numpy, used as a static permutation


def _hash_noise(gy, gz, t_seed, salt=1234):
    """Murmur-style integer hash -> [-1, 1) noise, bit-exact with the
    reference (reference: src/physics_utils.jl:17-28)."""
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
    return (h & np.uint32(0xFFFF)).astype(jnp.float32) / 32768.0 - 1.0


def _inlet_eq_1d(k_f32_cx, w_k, u):
    """Equilibrium for axis-aligned inlet/outlet flow: only the x velocity
    component enters cu (reference: src/physics_kernels.jl:99-113)."""
    cu = k_f32_cx * u
    return w_k * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * u * u)


def _parent_interp(plan: Dict, parent: Dict, u_fill, temporal_weight: float,
                   use_temporal: bool):
    """Trilinear + temporal coarse->fine interpolation with f_neq rescaling
    (reference: src/physics_interpolation.jl:16-138).  Vectorized over the
    static list of interface (cell, direction) pairs."""
    pk = plan["parent_k"]  # (np,)
    idx8 = plan["parent_idx"]  # (np, 8)
    val8 = plan["parent_valid"]  # (np, 8) bool
    w3 = plan["parent_w"]  # (np, 3)
    npair = pk.shape[0]
    if npair == 0:
        return jnp.zeros((0,), jnp.float32)

    Np = parent["rho"].shape[0]
    f_flat = parent["f"].reshape(27 * Np)
    fidx = pk[:, None] * Np + idx8
    f8 = f_flat[fidx]
    rho8 = parent["rho"][idx8]
    u8 = parent["vel"][:, idx8]  # (3, np, 8)

    if use_temporal and temporal_weight < 0.99:
        tw = jnp.float32(temporal_weight)
        f8 = parent["f_old"].reshape(27 * Np)[fidx] * (1.0 - tw) + f8 * tw
        rho8 = parent["rho_old"][idx8] * (1.0 - tw) + rho8 * tw
        u8 = parent["vel_old"][:, idx8] * (1.0 - tw) + u8 * tw

    w_k = _W[pk]
    # fallback chain: invalid corner 0 -> (w_k, 1, 0); other invalid -> corner 0
    v0 = val8[:, 0]
    f0 = jnp.where(v0, f8[:, 0], w_k)
    r0 = jnp.where(v0, rho8[:, 0], 1.0)
    u0 = jnp.where(v0[None, :], u8[:, :, 0], 0.0)
    f8 = jnp.where(val8, f8, f0[:, None])
    rho8 = jnp.where(val8, rho8, r0[:, None])
    u8 = jnp.where(val8[None], u8, u0[:, :, None])

    wx, wy, wz = w3[:, 0], w3[:, 1], w3[:, 2]

    def trilin(v):  # v: (..., np, 8), corner order x-fastest
        c00 = v[..., 0] * (1 - wx) + v[..., 1] * wx
        c10 = v[..., 2] * (1 - wx) + v[..., 3] * wx
        c01 = v[..., 4] * (1 - wx) + v[..., 5] * wx
        c11 = v[..., 6] * (1 - wx) + v[..., 7] * wx
        c0 = c00 * (1 - wy) + c10 * wy
        c1 = c01 * (1 - wy) + c11 * wy
        return c0 * (1 - wz) + c1 * wz

    f_int = trilin(f8)
    rho_int = trilin(rho8)
    u_int = trilin(u8)  # (3, np)

    cvec = _C[:, pk]  # (3, np)
    cu = jnp.sum(cvec * u_int, axis=0)
    usq = jnp.sum(u_int * u_int, axis=0)
    feq = rho_int * w_k * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
    return feq + (f_int - feq) * jnp.float32(plan["fneq_rescale"])


def stream_collide(
    f_in: jnp.ndarray,  # (27, nb, 512)
    vel_in: jnp.ndarray,  # (3, nb, 512)
    u_inlet: jnp.ndarray,  # scalar f32
    t_seed: jnp.ndarray,  # scalar i32 (timestep % 1e6)
    static: Dict,  # device arrays: plan + obstacle/sponge/wall_dist
    *,
    tau: float,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    use_temporal: bool,
    temporal_weight: float = 0.0,
    parent: Optional[Dict] = None,
):
    """Returns (f_out, rho_out, vel_out)."""
    nb = f_in.shape[1]
    N = nb * lat.BLOCK_CELLS
    plan = static["plan"]

    # ---- 1. streaming: roll within blocks ----------------------------------
    f_str = jnp.stack(
        [jnp.roll(f_in[k], int(lat.OFF[k]), axis=-1) for k in range(27)]
    )

    # ---- fixups for block-crossing / boundary sources ----------------------
    f_flat = f_in.reshape(-1)
    vals_gather = f_flat[plan["gather_src"]]

    ik = plan["inlet_k"]
    if ik.shape[0]:
        if inlet_turbulence > 0.0:
            noise = _hash_noise(plan["inlet_gy"], plan["inlet_gz"], t_seed)
            u_inst = u_inlet + noise * jnp.float32(inlet_turbulence) * u_inlet
        else:
            u_inst = jnp.broadcast_to(u_inlet, ik.shape).astype(jnp.float32)
        vals_inlet = _inlet_eq_1d(_CX[ik], _W[ik], u_inst)
    else:
        vals_inlet = jnp.zeros((0,), jnp.float32)

    ok = plan["outlet_k"]
    if ok.shape[0]:
        vals_outlet = _inlet_eq_1d(_CX[ok], _W[ok], u_inlet)
    else:
        vals_outlet = jnp.zeros((0,), jnp.float32)

    vals_const = plan["const_val"]
    vals_parent = _parent_interp(plan, parent, u_inlet, temporal_weight, use_temporal) \
        if parent is not None else jnp.zeros((0,), jnp.float32)

    vals = jnp.concatenate(
        [vals_gather, vals_inlet, vals_outlet, vals_const, vals_parent]
    )[plan["scatter_perm"]]
    f_str = (
        f_str.reshape(-1)
        .at[plan["scatter_dst"]]
        .set(vals, unique_indices=True, indices_are_sorted=True)
        .reshape(27, N)
    )

    # ---- 2. collision via the shared layout-agnostic core ------------------
    from .collide_math import collide

    vel_flat = vel_in.reshape(3, N)
    from ..core.plan import FACE_ROLL  # static roll shifts E,W,N,S,T,B

    nbrs = []
    for i in range(6):
        r = jnp.roll(vel_in, FACE_ROLL[i], axis=-1).reshape(3, N)
        r = r.at[:, static["vel_dst"][i]].set(
            vel_flat[:, static["vel_src"][i]], unique_indices=True
        )
        nbrs.append(r)

    f_out, rho_out, vel_out = collide(
        f_str,
        tuple(nbrs),
        static["obstacle"].reshape(N),
        static["sponge"].reshape(N),
        static["wall_dist"].reshape(N),
        u_inlet,
        tau=tau,
        c_wale=c_wale,
        nu_sgs_background=nu_sgs_background,
        wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    return (
        f_out.reshape(27, nb, lat.BLOCK_CELLS),
        rho_out.reshape(nb, lat.BLOCK_CELLS),
        vel_out.reshape(3, nb, lat.BLOCK_CELLS),
    )


def apply_bouzidi(f_out: jnp.ndarray, bz: Dict) -> jnp.ndarray:
    """Second-order interpolated bounce-back overwrite of f_out[cell, opp_k]
    (reference: src/bouzidi_kernel.jl:13-92), as one gather + static scatter
    on the uncorrected post-collision snapshot."""
    shape = f_out.shape
    flat = f_out.reshape(-1)
    vals = bz["coef_a"] * flat[bz["src_k"]] + bz["coef_b"] * flat[bz["src_other"]]
    return flat.at[bz["dst"]].set(vals, unique_indices=True).reshape(shape)
