"""Physical <-> lattice unit scaling and domain sizing.

Replicates the reference's domain construction math
(reference: src/physics_scaling.jl:66-176) with a frozen dataclass instead of
a mutable global singleton.  All sizing math is float64 on host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

from .config import CaseConfig

BLOCK_EDGE = 8


@dataclass(frozen=True)
class DomainParams:
    num_levels: int
    mesh_min: Tuple[float, float, float]
    mesh_max: Tuple[float, float, float]
    mesh_center: Tuple[float, float, float]
    mesh_extent: Tuple[float, float, float]
    reference_length: float
    reference_chord: float
    reference_area: float
    moment_center: Tuple[float, float, float]
    domain_size: Tuple[float, float, float]
    mesh_offset: Tuple[float, float, float]
    dx_fine: float
    dx_coarse: float
    dx_levels: Tuple[float, ...]
    nx_coarse: int
    ny_coarse: int
    nz_coarse: int
    bx_max: int
    by_max: int
    bz_max: int
    nu_lattice: float
    tau_levels: Tuple[float, ...]
    re_number: float
    u_physical: float
    rho_physical: float
    nu_physical: float
    length_scale: float
    time_scale: float
    velocity_scale: float
    force_scale: float
    tau_fine: float
    wall_model_active: bool
    symmetric: bool
    estimated_memory_gb: float


def compute_tau_fine(re: float, resolution: int, u_lattice: float) -> float:
    """tau at the finest level: 3 nu_lat + 0.5 with nu_lat = u_lat*N/Re
    (reference: src/physics_scaling.jl:66-69)."""
    nu_lattice_fine = float(u_lattice) * resolution / re
    return 3.0 * nu_lattice_fine + 0.5


def compute_max_levels_for_domain(
    domain_size: float, dx_fine: float, block_size: int, min_blocks: int
) -> int:
    """Cap on refinement levels so the coarse grid keeps >= min_blocks blocks
    (reference: src/physics_scaling.jl:71-74)."""
    ratio = domain_size / (dx_fine * min_blocks * block_size)
    return 1 if ratio < 1.0 else int(math.floor(1 + math.log2(ratio)))


def compute_domain_params(
    cfg: CaseConfig,
    mesh_min: Tuple[float, float, float],
    mesh_max: Tuple[float, float, float],
) -> DomainParams:
    """Domain sizing, per-level tau, and unit scales from mesh bounds
    (reference: src/physics_scaling.jl:86-176)."""
    mesh_center = tuple((a + b) / 2 for a, b in zip(mesh_min, mesh_max))
    mesh_extent = tuple(b - a for a, b in zip(mesh_min, mesh_max))

    if cfg.reference_length_for_meshing > 0:
        ref_length = cfg.reference_length_for_meshing
    else:
        dim = cfg.reference_dimension
        ref_length = {
            "x": mesh_extent[0],
            "y": mesh_extent[1],
            "z": mesh_extent[2],
        }.get(dim, max(mesh_extent))

    ref_chord = cfg.reference_chord if cfg.reference_chord > 0 else mesh_extent[0]
    if cfg.reference_area > 0:
        ref_area = cfg.reference_area
    else:
        frontal = mesh_extent[1] * mesh_extent[2]
        ref_area = frontal * 2 if cfg.symmetric_analysis else frontal

    u_phys = cfg.flow_velocity
    nu_phys = cfg.fluid_kinematic_viscosity
    rho_phys = cfg.fluid_density
    re_number = u_phys * ref_length / nu_phys

    tau_fine = max(
        compute_tau_fine(re_number, cfg.surface_resolution, cfg.u_lattice), cfg.tau_min
    )

    domain_x = ref_length * (cfg.domain_upstream + cfg.domain_downstream) + mesh_extent[0]
    if cfg.symmetric_analysis:
        domain_y = mesh_max[1] + ref_length * cfg.domain_lateral
    else:
        domain_y = mesh_extent[1] + 2 * ref_length * cfg.domain_lateral
    domain_z = mesh_extent[2] + 2 * ref_length * cfg.domain_height

    dx_fine = ref_length / cfg.surface_resolution
    min_domain = min(domain_x, domain_y, domain_z)
    max_levels_domain = compute_max_levels_for_domain(
        min_domain, dx_fine, BLOCK_EDGE, cfg.min_coarse_blocks
    )

    if cfg.num_levels > 0:
        num_levels = min(cfg.num_levels, max_levels_domain)
    elif cfg.auto_levels:
        num_levels = min(max_levels_domain, cfg.max_levels)
    else:
        num_levels = min(8, max_levels_domain)

    dx_coarse = dx_fine * 2 ** (num_levels - 1)
    dx_levels = tuple(dx_fine * 2 ** (num_levels - lvl) for lvl in range(1, num_levels + 1))

    def _round_blocks(sz: float) -> int:
        return max(
            BLOCK_EDGE,
            int(math.ceil(math.ceil(sz / dx_coarse) / BLOCK_EDGE) * BLOCK_EDGE),
        )

    nx_coarse = _round_blocks(domain_x)
    ny_coarse = _round_blocks(domain_y)
    nz_coarse = _round_blocks(domain_z)
    domain_x, domain_y, domain_z = (
        nx_coarse * dx_coarse,
        ny_coarse * dx_coarse,
        nz_coarse * dx_coarse,
    )
    bx_max, by_max, bz_max = (
        nx_coarse // BLOCK_EDGE,
        ny_coarse // BLOCK_EDGE,
        nz_coarse // BLOCK_EDGE,
    )

    mesh_x = ref_length * cfg.domain_upstream
    mesh_y = 0.0 if cfg.symmetric_analysis else (domain_y / 2 - mesh_center[1])
    mesh_z = domain_z / 2 - mesh_center[2]
    mesh_offset = (mesh_x - mesh_min[0], mesh_y, mesh_z)

    length_scale = dx_fine
    velocity_scale = u_phys / cfg.u_lattice
    time_scale = length_scale / velocity_scale
    nu_lattice_fine = nu_phys * time_scale / length_scale**2

    tau_levels = tuple(
        tau_fine
        if lvl == num_levels
        else 0.5 + (tau_fine - 0.5) * 2.0 ** (num_levels - lvl)
        for lvl in range(1, num_levels + 1)
    )

    force_scale = rho_phys * length_scale**4 / time_scale**2
    mc = cfg.moment_center
    moment_center = (
        mesh_min[0] + mesh_offset[0] + mc[0] * ref_chord,
        mesh_center[1] + mesh_offset[1] + mc[1] * ref_chord,
        mesh_center[2] + mesh_offset[2] + mc[2] * ref_chord,
    )

    bytes_per_cell = 220 if cfg.temporal_interpolation else 160
    total_cells_est = bx_max * by_max * bz_max * BLOCK_EDGE**3
    for _ in range(2, num_levels + 1):
        total_cells_est += int(math.ceil(total_cells_est * 0.08))
    estimated_memory_gb = total_cells_est * bytes_per_cell / 1e9

    return DomainParams(
        num_levels=num_levels,
        mesh_min=tuple(mesh_min),
        mesh_max=tuple(mesh_max),
        mesh_center=mesh_center,
        mesh_extent=mesh_extent,
        reference_length=ref_length,
        reference_chord=ref_chord,
        reference_area=ref_area,
        moment_center=moment_center,
        domain_size=(domain_x, domain_y, domain_z),
        mesh_offset=mesh_offset,
        dx_fine=dx_fine,
        dx_coarse=dx_coarse,
        dx_levels=dx_levels,
        nx_coarse=nx_coarse,
        ny_coarse=ny_coarse,
        nz_coarse=nz_coarse,
        bx_max=bx_max,
        by_max=by_max,
        bz_max=bz_max,
        nu_lattice=nu_lattice_fine,
        tau_levels=tau_levels,
        re_number=re_number,
        u_physical=u_phys,
        rho_physical=rho_phys,
        nu_physical=nu_phys,
        length_scale=length_scale,
        time_scale=time_scale,
        velocity_scale=velocity_scale,
        force_scale=force_scale,
        tau_fine=tau_fine,
        wall_model_active=cfg.wall_model_enabled,
        symmetric=cfg.symmetric_analysis,
        estimated_memory_gb=estimated_memory_gb,
    )
