"""Surface-stress aerodynamic force computation.

The reference maps each STL triangle to its nearest fluid cell with an
in-kernel expanding-shell search every time forces are evaluated
(reference: src/forces/surface.jl:138-266).  The search only depends on the
STATIC obstacle field and triangle positions, so here it runs ONCE at setup
(vectorized numpy); the runtime evaluation is a single jitted gather of
(rho, vel) at the mapped cells + elementwise stress math + one reduction —
atomics (reference: src/forces/surface.jl:354-364) become plain sums.

Stress model (reference: src/forces/surface.jl:32-89):
  p    = (rho - 1)/3 * rho_phys * velocity_scale^2           [Pa]
  tau  = rho * nu_lat * |u_t| / dist * (same scale), along the tangential
         velocity direction; dist = max(|cell - tri|/dx, 0.5) lattice units.

Pressure extrapolation (engine extension, `advanced.forces.extrapolate`,
default OFF = reference-parity sampling): a second sample further along the
outward surface normal extrapolates p linearly to the wall,
  p_wall = p1 + (p1 - p2) * d1 / (d2 - d1),   d = normal-projected distance,
factor clamped to [0, 2], falling back to p1 without a valid second cell.

Measured honestly (tools/wing_cv_probe.py, laminar Re 1e4 NACA wing at
N=48): the mapped drag of a STREAMLINED body is wrong either way (1-point
Cd -0.007, extrapolated -0.017, vs +0.067 from an independent
control-volume momentum balance of the same flow; lift agrees between
mapping and control volume).  The failure is a resolution floor of
surface-stress sampling itself — near the thin trailing edge the nearest
fluid cell sits on the WRONG side of the section, and near-wall bounce-back
pressure artifacts are amplified by extrapolation.  Blunt-body (sphere)
drag is insensitive: it is a large wake pressure difference, validated <5%
against the reference.  The reference's expanding-shell sampling
(src/forces/surface.jl:191-240) shares all of this; it ships no wing force
results.

Forces (reference: src/forces/surface.jl:282-366):
  dF_p = -p n A,  dF_v = tau A,  dM = r x dF about the moment center,
with symmetry doubling of Fx/Fz/My and zeroing of Fy/Mx/Mz for half models
(reference: src/forces/surface.jl:517-526).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger("open_ludwig")

from ..domain.builder import LevelGeometry
from ..geometry import TriMesh
from ..scaling import DomainParams

BLOCK_EDGE = 8


def _second_sample(tc, n_hat, bc, has, dx, dims, is_fluid):
    """Second pressure sample along the OUTWARD surface normal for wall
    extrapolation: nearest fluid cell to the point one cell further out
    than the first sample's normal-projected distance.  Returns
    (cell_coords2, has2, d1n, d2n) with distances normal-projected in
    lattice units."""
    cc1 = (bc + 0.5) * dx
    d1n = np.einsum("ij,ij->i", cc1 - tc, n_hat)
    d1n = np.maximum(d1n, 0.1 * dx)  # guard: first cell on the surface plane
    target = tc + n_hat * (d1n + 1.0 * dx)[:, None]
    off2 = np.stack(
        np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)
    g2 = np.floor(target / dx).astype(np.int64)
    cand = g2[:, None, :] + off2[None, :, :]
    valid = np.all((cand >= 0) & (cand < dims[None, None, :]), axis=2)
    cc = np.clip(cand, 0, dims - 1)
    fluid = valid & is_fluid(cc)
    cent = (cand + 0.5) * dx
    dd = np.sum((cent - target[:, None, :]) ** 2, axis=2)
    dd = np.where(fluid, dd, np.inf)
    b2 = np.argmin(dd, axis=1)
    has2 = np.isfinite(dd[np.arange(len(b2)), b2])
    bc2 = cc[np.arange(len(b2)), b2]
    d2n = np.einsum("ij,ij->i", (bc2 + 0.5) * dx - tc, n_hat)
    # meaningful separation along the normal, and a distinct cell
    has2 &= has & (d2n - d1n > 0.25 * dx) & ~np.all(bc2 == bc, axis=1)
    return bc2, has2, d1n / dx, d2n / dx


def build_triangle_cell_map(
    mesh: TriMesh,
    geo: LevelGeometry,
    params: DomainParams,
    search_radius: int = 5,
    chunk: int = 4096,
) -> Dict[str, np.ndarray]:
    """For each triangle: nearest fluid cell (expanding-shell semantics:
    scan shells outward, stop one shell after the first hit, keep the
    minimum-distance candidate) and the wall distance in lattice units."""
    dx = geo.dx
    offset = np.asarray(params.mesh_offset)
    centers = mesh.centers + offset[None, :]  # domain coords
    n_tri = len(centers)
    dims_cells = np.asarray(geo.grid_cells)

    # dense obstacle/active lookup for the finest level
    obstacle_d = np.ones(tuple(dims_cells), bool)  # inactive treated as non-fluid
    lf = np.arange(512)
    lx, ly, lz = lf % 8, (lf // 8) % 8, lf // 64
    gx = geo.coords[:, 0, None] * 8 + lx[None, :]
    gy = geo.coords[:, 1, None] * 8 + ly[None, :]
    gz = geo.coords[:, 2, None] * 8 + lz[None, :]
    obstacle_d[gx, gy, gz] = geo.obstacle
    block_ptr = geo.block_ptr

    # offsets ordered by Chebyshev shell radius
    r = search_radius
    off = np.stack(
        np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), np.arange(-r, r + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    shell = np.abs(off).max(axis=1)
    order = np.argsort(shell, kind="stable")
    off = off[order]
    shell = shell[order]

    cell_idx = np.full(n_tri, -1, np.int64)  # flat cell index b*512 + local
    wall_dist = np.full(n_tri, 0.5, np.float64)
    found = np.zeros(n_tri, bool)
    cell_idx2 = np.zeros(n_tri, np.int64)
    found2 = np.zeros(n_tri, bool)
    dn1 = np.full(n_tri, 0.5, np.float64)
    dn2 = np.full(n_tri, 1.5, np.float64)

    def blk_flat(bc):
        blk = bc // 8
        bid = block_ptr[blk[:, 0], blk[:, 1], blk[:, 2]].astype(np.int64)
        loc = bc % 8
        return bid * 512 + loc[:, 2] * 64 + loc[:, 1] * 8 + loc[:, 0]

    for s in range(0, n_tri, chunk):
        e = min(s + chunk, n_tri)
        tc = centers[s:e]
        # anchor cell: reference uses floor(t/dx)+1 in 1-based = floor(t/dx) 0-based
        g0 = np.floor(tc / dx).astype(np.int64)  # (m, 3)
        cand = g0[:, None, :] + off[None, :, :]  # (m, no, 3)
        valid = np.all((cand >= 0) & (cand < dims_cells[None, None, :]), axis=2)
        cc = np.clip(cand, 0, dims_cells - 1)
        fluid = valid & ~obstacle_d[cc[..., 0], cc[..., 1], cc[..., 2]]
        cell_cent = (cand + 0.5) * dx
        d2 = np.sum((cell_cent - tc[:, None, :]) ** 2, axis=2)
        d2 = np.where(fluid, d2, np.inf)
        # shell-limited search: allowed shells <= first_hit_shell + 1
        first_shell = np.where(
            fluid.any(axis=1), shell[np.argmax(fluid, axis=1)], r + 1
        )
        allowed = shell[None, :] <= np.minimum(first_shell + 1, r)[:, None]
        d2 = np.where(allowed, d2, np.inf)
        best = np.argmin(d2, axis=1)
        has = np.isfinite(d2[np.arange(len(best)), best])
        bc = cc[np.arange(len(best)), best]  # (m, 3) best cell coords
        cell_idx[s:e] = np.where(has, blk_flat(bc), 0)
        found[s:e] = has
        wd = np.sqrt(d2[np.arange(len(best)), best]) / dx
        wall_dist[s:e] = np.where(has, np.maximum(wd, 0.5), 0.5)

        bc2, has2, d1n, d2n = _second_sample(
            tc, mesh.normals[s:e], bc, has, dx, dims_cells,
            lambda cc_: ~obstacle_d[cc_[..., 0], cc_[..., 1], cc_[..., 2]],
        )
        cell_idx2[s:e] = np.where(has2, blk_flat(bc2), 0)
        found2[s:e] = has2
        dn1[s:e] = d1n
        dn2[s:e] = np.where(has2, d2n, d1n + 1.0)

    return {
        "cell_idx": cell_idx.astype(np.int32),
        "wall_dist": wall_dist.astype(np.float32),
        "found": found,
        "cell_idx2": cell_idx2.astype(np.int32),
        "found2": found2,
        "dn1": dn1.astype(np.float32),
        "dn2": dn2.astype(np.float32),
    }


@dataclass
class ForceContext:
    """Device-side constants for force evaluation."""

    cell_idx: jnp.ndarray  # (n_tri,)
    wall_dist: jnp.ndarray  # (n_tri,) lattice units
    found: jnp.ndarray  # (n_tri,) bool
    normals: jnp.ndarray  # (3, n_tri)
    areas: jnp.ndarray  # (n_tri,)
    centers: jnp.ndarray  # (3, n_tri) in domain coords (offset applied)
    moment_center: jnp.ndarray  # (3,)
    tau_molecular: float
    pressure_scale: float
    q_inf: float
    area_ref: float
    chord_ref: float
    symmetric: bool
    # wall-normal pressure extrapolation (second sample along the normal)
    cell_idx2: jnp.ndarray = None  # (n_tri,)
    found2: jnp.ndarray = None  # (n_tri,) bool
    dn1: jnp.ndarray = None  # (n_tri,) normal distance of sample 1 (lattice)
    dn2: jnp.ndarray = None  # (n_tri,) normal distance of sample 2
    extrapolate: bool = True


def _report_coverage(found: np.ndarray, what: str) -> None:
    """Stress-mapping coverage diagnostics, mirroring the reference's
    mapped/total triangle statistics (reference: forces/surface.jl:425-445)."""
    n = int(found.size)
    ok = int(np.count_nonzero(found))
    msg = "[Forces] stress mapping (%s): %d/%d triangles mapped (%.1f%%)"
    log.info(msg, what, ok, n, 100.0 * ok / max(n, 1))
    if ok < n:
        log.warning(
            "[Forces] %d triangles found no nearby fluid cell; their "
            "pressure/shear contribution is zero", n - ok,
        )


def make_force_context(
    mesh: TriMesh, geo: LevelGeometry, params: DomainParams,
    search_radius: int = 5, extrapolate: bool = True,
) -> ForceContext:
    m = build_triangle_cell_map(mesh, geo, params, search_radius)
    _report_coverage(m["found"], "blocks layout")
    offset = np.asarray(params.mesh_offset)
    pressure_scale = params.rho_physical * params.velocity_scale**2
    return ForceContext(
        cell_idx=jnp.asarray(m["cell_idx"]),
        wall_dist=jnp.asarray(m["wall_dist"]),
        found=jnp.asarray(m["found"]),
        normals=jnp.asarray(mesh.normals.T.astype(np.float32)),
        areas=jnp.asarray(mesh.areas.astype(np.float32)),
        centers=jnp.asarray((mesh.centers + offset).T.astype(np.float32)),
        moment_center=jnp.asarray(np.asarray(params.moment_center, np.float32)),
        tau_molecular=float(geo.tau),
        pressure_scale=float(pressure_scale),
        q_inf=float(0.5 * params.rho_physical * params.u_physical**2),
        area_ref=float(params.reference_area),
        chord_ref=float(params.reference_chord),
        symmetric=bool(params.symmetric),
        cell_idx2=jnp.asarray(m["cell_idx2"]),
        found2=jnp.asarray(m["found2"]),
        dn1=jnp.asarray(m["dn1"]),
        dn2=jnp.asarray(m["dn2"]),
        extrapolate=extrapolate,
    )


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _surface_stresses(rho_flat, vel_flat, ctx_arrays, tau_mol, p_scale, q_inf,
                      area_ref_chord, symmetric, extrapolate=False):
    (cell_idx, wall_dist, found, normals, areas, centers, mc,
     cell_idx2, found2, dn1, dn2) = ctx_arrays
    rho_c = rho_flat[cell_idx]
    u_c = vel_flat[:, cell_idx]  # (3, n)

    p = (rho_c - 1.0) / 3.0 * p_scale
    if extrapolate:
        # linear extrapolation to the wall along the outward normal; the
        # factor is clamped (noise amplification) and falls back to the
        # plain sample where no valid second cell exists
        p2 = (rho_flat[cell_idx2] - 1.0) / 3.0 * p_scale
        fac = jnp.clip(dn1 / jnp.maximum(dn2 - dn1, 0.25), 0.0, 2.0)
        p = jnp.where(found2, p + (p - p2) * fac, p)
    u_dot_n = jnp.sum(u_c * normals, axis=0)
    ut = u_c - u_dot_n[None, :] * normals
    ut_mag = jnp.sqrt(jnp.sum(ut * ut, axis=0))
    nu_lat = (tau_mol - 0.5) / 3.0
    shear_ok = (ut_mag > 1e-10) & (wall_dist > 0.01)
    tau_mag = rho_c * nu_lat * ut_mag / jnp.maximum(wall_dist, 0.01) * p_scale
    tau_vec = jnp.where(
        shear_ok[None, :], ut / jnp.maximum(ut_mag, 1e-20)[None, :] * tau_mag, 0.0
    )
    p = jnp.where(found, p, 0.0)
    tau_vec = jnp.where(found[None, :], tau_vec, 0.0)

    dFp = -p[None, :] * normals * areas[None, :]  # (3, n)
    dFv = tau_vec * areas[None, :]
    dF = dFp + dFv
    rvec = centers - mc[:, None]
    dM = jnp.cross(rvec.T, dF.T).T  # (3, n)

    Fp = jnp.sum(dFp, axis=1)
    Fv = jnp.sum(dFv, axis=1)
    M = jnp.sum(dM, axis=1)
    return p, tau_vec, Fp, Fv, M


@dataclass
class ForceResult:
    Fx: float = 0.0
    Fy: float = 0.0
    Fz: float = 0.0
    Fx_pressure: float = 0.0
    Fy_pressure: float = 0.0
    Fz_pressure: float = 0.0
    Fx_viscous: float = 0.0
    Fy_viscous: float = 0.0
    Fz_viscous: float = 0.0
    Mx: float = 0.0
    My: float = 0.0
    Mz: float = 0.0
    Cd: float = 0.0
    Cl: float = 0.0
    Cs: float = 0.0
    Cmx: float = 0.0
    Cmy: float = 0.0
    Cmz: float = 0.0
    pressure_map: np.ndarray = None  # (n_tri,) Pa
    shear_map: np.ndarray = None  # (3, n_tri) Pa
    force_map: np.ndarray = None  # (3, n_tri) N, momentum-exchange only


def compute_aerodynamics(state: Dict, ctx: ForceContext) -> ForceResult:
    """Map stresses and integrate forces/coefficients for the finest level
    state (reference: src/forces/surface.jl:592-600)."""
    rho_flat = state["rho"].reshape(-1)
    vel_flat = state["vel"].reshape(3, -1)
    extrap = bool(ctx.extrapolate) and ctx.cell_idx2 is not None
    ctx_arrays = (
        ctx.cell_idx,
        ctx.wall_dist,
        ctx.found,
        ctx.normals,
        ctx.areas,
        ctx.centers,
        ctx.moment_center,
        ctx.cell_idx2 if extrap else ctx.cell_idx,
        ctx.found2 if extrap else ctx.found,
        ctx.dn1 if extrap else ctx.wall_dist,
        ctx.dn2 if extrap else ctx.wall_dist,
    )
    p, tau_vec, Fp, Fv, M = _surface_stresses(
        rho_flat,
        vel_flat,
        ctx_arrays,
        ctx.tau_molecular,
        ctx.pressure_scale,
        ctx.q_inf,
        ctx.area_ref,
        ctx.symmetric,
        extrap,
    )
    Fp = np.asarray(Fp, np.float64)
    Fv = np.asarray(Fv, np.float64)
    M = np.asarray(M, np.float64)
    if ctx.symmetric:
        Fp = np.array([2 * Fp[0], 0.0, 2 * Fp[2]])
        Fv = np.array([2 * Fv[0], 0.0, 2 * Fv[2]])
        M = np.array([0.0, 2 * M[1], 0.0])
    F = Fp + Fv
    res = ForceResult(
        Fx=F[0], Fy=F[1], Fz=F[2],
        Fx_pressure=Fp[0], Fy_pressure=Fp[1], Fz_pressure=Fp[2],
        Fx_viscous=Fv[0], Fy_viscous=Fv[1], Fz_viscous=Fv[2],
        Mx=M[0], My=M[1], Mz=M[2],
        pressure_map=np.asarray(p),
        shear_map=np.asarray(tau_vec),
    )
    F_ref = ctx.q_inf * ctx.area_ref
    M_ref = F_ref * ctx.chord_ref
    if F_ref > 1e-10:
        res.Cd = F[0] / F_ref
        res.Cl = F[2] / F_ref
        res.Cs = F[1] / F_ref
    if M_ref > 1e-10:
        res.Cmx = M[0] / M_ref
        res.Cmy = M[1] / M_ref
        res.Cmz = M[2] / M_ref
    return res


@dataclass
class MEMContext:
    """Momentum-exchange force evaluation across the fluid/solid interface.

    The reference carries a momentum-exchange method on disk but dead
    (reference: src/forces/global.jl:15-148, excluded at src/forces.jl:58-60)
    that sums 2 f_k c_k over its Bouzidi ray-hit list.  That list cannot be
    used directly here (nor could it in the reference): the SAT voxelizer is
    conservative, so the obstacle mask extends past the true surface and the
    ray-hit cells straddle the wall — 97% of them are obstacle-marked cells
    whose populations are bounce-back ghost storage (measured on the sphere,
    tools/mem_probe.py).  The engine's actual no-slip boundary is the
    obstacle-mask interface, so the force on the body is the discrete
    momentum-flux balance across that interface:

        F_lat = sum over links (fluid x_f, direction j with x_f + c_j solid)
                of [ f_j(x_f) + f_jbar(x_f + c_j) ] c_j

    evaluated on the committed post-collision state: f_j(x_f) is the
    outgoing population that will stream into the solid next sub-step, and
    the solid neighbor's f_jbar slot holds exactly the reflected population
    the fluid will pull back (whether plain bounce-back or the Bouzidi
    correction produced it).  For halfway bounce-back this reduces to the
    classic 2 f_j c_j.  The rebuild's own control-volume study proved the
    stress-mapping path CANNOT resolve streamlined-body drag (nearest-cell
    sampling lands on the wrong side of thin sections — see the module
    docstring and VALIDATION.md), which is the failure mode momentum
    exchange avoids: no wall-normal sampling at all.  Enabled via
    `advanced.forces.method: momentum_exchange`.

    Numerics: the rest-state part of each population (the lattice weight w)
    is subtracted before the device-side sums — it carries the uniform
    rho0/3 pressure whose closed-surface integral is zero — and its exact
    float64 flux (`rest_F`, ~1e-13 for closed bodies) is added back on the
    host, so the reported force is free of large-term cancellation noise in
    f32/bf16.

    Lattice->physical conversion: F_phys = F_lat * force_scale with
    force_scale = rho_phys dx^4/dt^2 (scaling.py, dx/dt at the finest
    level where the links live); moment arms are precomputed in METERS so
    M_phys = M * force_scale (the reference's dead code multiplied by a
    further length_scale on a meter-valued arm, reference:
    src/forces/global.jl:126-130 — a unit bug we do not reproduce)."""

    idx_out: jnp.ndarray  # (n_links,) flat f-index of the outgoing slot
    idx_in: jnp.ndarray  # (n_links,) flat f-index of the reflected slot
    w_k: jnp.ndarray  # (n_links,) lattice weight of the link direction
    c: jnp.ndarray  # (3, n_links) f32 direction vectors
    r: jnp.ndarray  # (3, n_links) meters, link midpoint - moment center
    tri: jnp.ndarray  # (n_links,) nearest-triangle id
    n_tri: int
    rest_F: np.ndarray  # (3,) f64 lattice flux of the rest state (~0)
    rest_F_tri: np.ndarray  # (3, n_tri) f64 per-triangle rest flux
    rest_M: np.ndarray  # (3,) f64 rest-state moment contribution
    force_scale: float
    q_inf: float
    area_ref: float
    chord_ref: float
    symmetric: bool
    g_storage: bool  # f arrays hold g = f - w (bf16 storage)

    @property
    def n_links(self) -> int:
        return int(self.idx_out.shape[0])


def make_mem_context(patch, params: DomainParams, mesh: TriMesh,
                     g_storage: bool) -> Optional["MEMContext"]:
    """Enumerate fluid->solid interface links from the obstacle mask (one
    shifted-window pass per lattice direction) and attribute each link to
    its nearest STL triangle for the per-triangle surface force map.  Setup
    runs once in numpy; the runtime evaluation is two flat gathers plus
    segment sums (reference's atomics at src/forces/global.jl:105-141
    become segment-sum reductions)."""
    from .. import lattice as lat

    X, Y, Z = patch.interior
    obs_i = np.asarray(patch.obstacle)[:X, :Y, :Z]
    if not obs_i.any():
        return None
    # obstacle extended by a False ring: neighbors outside the interior
    # (domain faces, patch padding) never count as wall
    obs_ext = np.zeros((X + 2, Y + 2, Z + 2), bool)
    obs_ext[1:-1, 1:-1, 1:-1] = obs_i
    fluid = ~obs_i
    # restrict the scan to the obstacle bounding box + 1-cell shell
    bidx = np.argwhere(obs_i)
    lo_b = np.maximum(bidx.min(0) - 1, 0)
    hi_b = np.minimum(bidx.max(0) + 2, [X, Y, Z])
    sl = tuple(slice(l, h) for l, h in zip(lo_b, hi_b))
    fl_sub = fluid[sl]

    gx_l, gy_l, gz_l, k_l = [], [], [], []
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        if cx == 0 and cy == 0 and cz == 0:
            continue
        nb = obs_ext[
            1 + cx + lo_b[0]: 1 + cx + hi_b[0],
            1 + cy + lo_b[1]: 1 + cy + hi_b[1],
            1 + cz + lo_b[2]: 1 + cz + hi_b[2],
        ]
        xs, ys, zs = np.nonzero(fl_sub & nb)
        if len(xs) == 0:
            continue
        gx_l.append(xs + lo_b[0])
        gy_l.append(ys + lo_b[1])
        gz_l.append(zs + lo_b[2])
        k_l.append(np.full(len(xs), k, np.int32))
    if not gx_l:
        return None
    gx = np.concatenate(gx_l).astype(np.int64)
    gy = np.concatenate(gy_l).astype(np.int64)
    gz = np.concatenate(gz_l).astype(np.int64)
    k = np.concatenate(k_l)

    XS, YS, ZS = patch.padded
    N = XS * YS * ZS
    cell = (gx * YS + gy) * ZS + gz
    ncell = ((gx + lat.C_X[k]) * YS + (gy + lat.C_Y[k])) * ZS \
        + (gz + lat.C_Z[k])
    idx_out = k.astype(np.int64) * N + cell
    idx_in = lat.OPP[k].astype(np.int64) * N + ncell

    c = np.stack([lat.C_X[k], lat.C_Y[k], lat.C_Z[k]]).astype(np.float64)
    # link midpoints (where the wall crossing sits) in meters, domain frame
    lo = np.asarray(patch.lo, np.float64)
    mid = (np.stack([gx, gy, gz]).astype(np.float64)
           + lo[:, None] + 0.5 + 0.5 * c) * patch.dx
    r = mid - np.asarray(params.moment_center, np.float64)[:, None]

    # nearest-triangle attribution of the link midpoint
    from scipy.spatial import cKDTree

    cent_dom = mesh.centers + np.asarray(params.mesh_offset)[None, :]
    tri_id = cKDTree(cent_dom).query(mid.T, workers=-1)[1].astype(np.int32)
    n_tri = int(mesh.n_triangles)

    # exact rest-state flux (2 w_j c_j per link) in float64; ~0 for closed
    # bodies — kept so the reported force is exactly the full-f balance
    w = lat.W[k].astype(np.float64)
    rest_dF = 2.0 * w[None, :] * c
    rest_F = rest_dF.sum(axis=1)
    rest_M = np.cross(r.T, rest_dF.T).sum(axis=0)
    rest_F_tri = np.zeros((3, n_tri))
    np.add.at(rest_F_tri.T, tri_id, rest_dF.T)

    return MEMContext(
        idx_out=jnp.asarray(idx_out.astype(np.int32)),
        idx_in=jnp.asarray(idx_in.astype(np.int32)),
        w_k=jnp.asarray(w.astype(np.float32)),
        c=jnp.asarray(c.astype(np.float32)),
        r=jnp.asarray(r.astype(np.float32)),
        tri=jnp.asarray(tri_id),
        n_tri=n_tri,
        rest_F=rest_F,
        rest_F_tri=rest_F_tri,
        rest_M=rest_M,
        force_scale=float(params.force_scale),
        q_inf=float(0.5 * params.rho_physical * params.u_physical**2),
        area_ref=float(params.reference_area),
        chord_ref=float(params.reference_chord),
        symmetric=bool(params.symmetric),
        g_storage=bool(g_storage),
    )


@partial(jax.jit, static_argnums=(6, 7))
def _mem_sums(f_flat, idx_out, idx_in, w_k, c, r, g_storage, n_tri, tri):
    vo = f_flat[idx_out].astype(jnp.float32)
    vi = f_flat[idx_in].astype(jnp.float32)
    if not g_storage:  # f32 storage holds full f; work in deviations g
        vo = vo - w_k
        vi = vi - w_k
    kick = vo + vi  # deviation part of the momentum to the wall per step
    dF = kick[None, :] * c  # (3, n_links)
    F = jnp.sum(dF, axis=1)
    M = jnp.sum(jnp.cross(r.T, dF.T).T, axis=1)
    # per-triangle attribution (nearest triangle to the link midpoint)
    F_tri = jax.vmap(
        lambda row: jax.ops.segment_sum(row, tri, num_segments=n_tri)
    )(dF)
    return F, M, F_tri


def compute_aerodynamics_mem(
    state: Dict, ctx: "MEMContext", base: Optional[ForceResult] = None
) -> ForceResult:
    """Integrated forces/moments/coefficients by momentum exchange.  When
    `base` (a stress-mapping result) is given, its per-triangle pressure and
    shear maps are kept for surface VTK output and only the integrals are
    replaced — the momentum-exchange method has no pressure/viscous
    decomposition (totals go in Fx etc.; the *_pressure/_viscous split
    retains the stress-mapping estimate when available, else total/zero)."""
    F_lat, M_lat, F_tri = _mem_sums(
        state["f"].reshape(-1), ctx.idx_out, ctx.idx_in, ctx.w_k, ctx.c,
        ctx.r, ctx.g_storage, ctx.n_tri, ctx.tri,
    )
    F = (np.asarray(F_lat, np.float64) + ctx.rest_F) * ctx.force_scale
    M = (np.asarray(M_lat, np.float64) + ctx.rest_M) * ctx.force_scale
    if ctx.symmetric:
        F = np.array([2 * F[0], 0.0, 2 * F[2]])
        M = np.array([0.0, 2 * M[1], 0.0])
    res = ForceResult(
        Fx=F[0], Fy=F[1], Fz=F[2],
        Mx=M[0], My=M[1], Mz=M[2],
        Fx_pressure=base.Fx_pressure if base else F[0],
        Fy_pressure=base.Fy_pressure if base else F[1],
        Fz_pressure=base.Fz_pressure if base else F[2],
        Fx_viscous=base.Fx_viscous if base else 0.0,
        Fy_viscous=base.Fy_viscous if base else 0.0,
        Fz_viscous=base.Fz_viscous if base else 0.0,
        pressure_map=base.pressure_map if base else None,
        shear_map=base.shear_map if base else None,
    )
    res.force_map = (
        np.asarray(F_tri, np.float64) + ctx.rest_F_tri
    ) * ctx.force_scale  # (3, n_tri) N
    F_ref = ctx.q_inf * ctx.area_ref
    M_ref = F_ref * ctx.chord_ref
    if F_ref > 1e-10:
        res.Cd = F[0] / F_ref
        res.Cl = F[2] / F_ref
        res.Cs = F[1] / F_ref
    if M_ref > 1e-10:
        res.Cmx = M[0] / M_ref
        res.Cmy = M[1] / M_ref
        res.Cmz = M[2] / M_ref
    return res


def build_triangle_cell_map_dense(
    mesh: TriMesh,
    patch,
    params: DomainParams,
    search_radius: int = 5,
    chunk: int = 4096,
) -> Dict[str, np.ndarray]:
    """Dense-patch variant of the triangle->fluid-cell mapping: the finest
    level is one dense box, so the shell search runs directly on its obstacle
    array (patch-local coordinates; returned indices are flat into the padded
    (XS, YS, ZS) state arrays)."""
    dx = patch.dx
    offset = np.asarray(params.mesh_offset)
    lo = np.asarray(patch.lo)
    centers = mesh.centers + offset[None, :] - lo[None, :] * dx  # patch-local
    n_tri = len(centers)
    X, Y, Z = patch.interior
    XS, YS, ZS = patch.padded
    obstacle = patch.obstacle[:X, :Y, :Z]

    r = search_radius
    off = np.stack(
        np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), np.arange(-r, r + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    shell = np.abs(off).max(axis=1)
    order = np.argsort(shell, kind="stable")
    off = off[order]
    shell = shell[order]

    cell_idx = np.zeros(n_tri, np.int64)
    wall_dist = np.full(n_tri, 0.5, np.float64)
    found = np.zeros(n_tri, bool)
    cell_idx2 = np.zeros(n_tri, np.int64)
    found2 = np.zeros(n_tri, bool)
    dn1 = np.full(n_tri, 0.5, np.float64)
    dn2 = np.full(n_tri, 1.5, np.float64)
    dims = np.array([X, Y, Z])
    for s in range(0, n_tri, chunk):
        e = min(s + chunk, n_tri)
        tc = centers[s:e]
        g0 = np.floor(tc / dx).astype(np.int64)
        cand = g0[:, None, :] + off[None, :, :]
        valid = np.all((cand >= 0) & (cand < dims[None, None, :]), axis=2)
        cc = np.clip(cand, 0, dims - 1)
        fluid = valid & ~obstacle[cc[..., 0], cc[..., 1], cc[..., 2]]
        cell_cent = (cand + 0.5) * dx
        d2 = np.sum((cell_cent - tc[:, None, :]) ** 2, axis=2)
        d2 = np.where(fluid, d2, np.inf)
        first_shell = np.where(fluid.any(axis=1), shell[np.argmax(fluid, axis=1)], r + 1)
        allowed = shell[None, :] <= np.minimum(first_shell + 1, r)[:, None]
        d2 = np.where(allowed, d2, np.inf)
        best = np.argmin(d2, axis=1)
        has = np.isfinite(d2[np.arange(len(best)), best])
        bc = cc[np.arange(len(best)), best]
        flat = (bc[:, 0] * YS + bc[:, 1]) * ZS + bc[:, 2]
        cell_idx[s:e] = np.where(has, flat, 0)
        found[s:e] = has
        wd = np.sqrt(d2[np.arange(len(best)), best]) / dx
        wall_dist[s:e] = np.where(has, np.maximum(wd, 0.5), 0.5)

        bc2, has2, d1n, d2n = _second_sample(
            tc, mesh.normals[s:e], bc, has, dx, dims,
            lambda cc_: ~obstacle[cc_[..., 0], cc_[..., 1], cc_[..., 2]],
        )
        flat2 = (bc2[:, 0] * YS + bc2[:, 1]) * ZS + bc2[:, 2]
        cell_idx2[s:e] = np.where(has2, flat2, 0)
        found2[s:e] = has2
        dn1[s:e] = d1n
        dn2[s:e] = np.where(has2, d2n, d1n + 1.0)
    return {
        "cell_idx": cell_idx.astype(np.int32),
        "wall_dist": wall_dist.astype(np.float32),
        "found": found,
        "cell_idx2": cell_idx2.astype(np.int32),
        "found2": found2,
        "dn1": dn1.astype(np.float32),
        "dn2": dn2.astype(np.float32),
    }


def make_force_context_dense(mesh: TriMesh, patch, params: DomainParams,
                             search_radius: int = 5,
                             extrapolate: bool = True) -> ForceContext:
    m = build_triangle_cell_map_dense(mesh, patch, params, search_radius)
    _report_coverage(m["found"], "patch layout")
    offset = np.asarray(params.mesh_offset)
    pressure_scale = params.rho_physical * params.velocity_scale**2
    return ForceContext(
        cell_idx=jnp.asarray(m["cell_idx"]),
        wall_dist=jnp.asarray(m["wall_dist"]),
        found=jnp.asarray(m["found"]),
        normals=jnp.asarray(mesh.normals.T.astype(np.float32)),
        areas=jnp.asarray(mesh.areas.astype(np.float32)),
        centers=jnp.asarray((mesh.centers + offset).T.astype(np.float32)),
        moment_center=jnp.asarray(np.asarray(params.moment_center, np.float32)),
        tau_molecular=float(patch.tau),
        pressure_scale=float(pressure_scale),
        q_inf=float(0.5 * params.rho_physical * params.u_physical**2),
        area_ref=float(params.reference_area),
        chord_ref=float(params.reference_chord),
        symmetric=bool(params.symmetric),
        cell_idx2=jnp.asarray(m["cell_idx2"]),
        found2=jnp.asarray(m["found2"]),
        dn1=jnp.asarray(m["dn1"]),
        dn2=jnp.asarray(m["dn2"]),
        extrapolate=extrapolate,
    )
