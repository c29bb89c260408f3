"""Nested dense-patch domain layout.

The reference exploits sparsity with 8^3 blocks + neighbor tables
(reference: src/blocks.jl, src/domain.jl).  The dense-patch layout takes
coarse-grained sparsity instead: ONE tight dense box per refinement level
(level 1 = the full wind tunnel, exactly like the reference's dense level 1).
Streaming then becomes fixed-offset reads, refinement-interface coupling
becomes dense slab upsampling, and the hot path contains no gather/scatter
at all.  The 8^3-block machinery remains available as the general path
(core.plan / ops.stream_collide); this module is the production layout.

Axis order is (x, y, z) with arrays shaped (27, XS, YS, ZS).  y and z are
stored unpadded; x is padded only to a multiple of the x-slab device count
(`x_multiple`).  Pad cells are marked obstacle and never consumed by
interior physics.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import CaseConfig
from ..geometry import TriMesh
from ..scaling import DomainParams
from ..domain.bouzidi import BouzidiData, compute_bouzidi
from ..domain.fields import sponge_for_cells, wall_distance_dense
from ..domain.voxelize import flood_fill_dense, voxelize_dense
from .. import lattice as lat

log = logging.getLogger("open_ludwig")

# face ids: 0 x-min, 1 x-max, 2 y-min, 3 y-max, 4 z-min, 5 z-max
FACE_AXIS = (0, 0, 1, 1, 2, 2)
FACE_SIDE = (0, 1, 0, 1, 0, 1)
# face type codes
BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Z, BC_INTERFACE = range(5)
DOMAIN_FACE_BC = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)


def _ceil(v, m):
    return int(-(-v // m) * m)


@dataclass
class PatchLevel:
    """One refinement level as a dense box (host-side static data)."""

    level_id: int  # 1-based, 1 = coarsest
    dx: float
    tau: float
    lo: Tuple[int, int, int]  # global cell offset in level-l coordinates
    interior: Tuple[int, int, int]  # (X, Y, Z) simulated cells
    padded: Tuple[int, int, int]  # (XS, YS, ZS) array dims
    face_bc: Tuple[int, ...]  # per face: BC_* code
    obstacle: np.ndarray  # (XS, YS, ZS) bool (pads True)
    sponge: np.ndarray  # (XS, YS, ZS) f32
    wall_dist: np.ndarray  # (XS, YS, ZS) f32
    bouzidi: Optional[BouzidiData] = None

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.interior))

    @property
    def n_padded(self) -> int:
        return int(np.prod(self.padded))


def _pad_field(arr: np.ndarray, padded, fill) -> np.ndarray:
    out = np.full(padded, fill, arr.dtype)
    out[: arr.shape[0], : arr.shape[1], : arr.shape[2]] = arr
    return out


def build_patches(
    cfg: CaseConfig, mesh: TriMesh, params: DomainParams,
    x_multiple: int = 1,
) -> List[PatchLevel]:
    """x_multiple > 1 pads the x (slab) dim of every level to that multiple
    so x-slab device sharding divides evenly.  Pad planes sit beyond the
    interior x-face whose BC masks are at interior coordinates, so they are
    never read by interior physics (obstacle-filled)."""
    num_levels = params.num_levels
    if x_multiple <= 1 and cfg.devices > 1:
        x_multiple = cfg.devices
    offset = np.asarray(params.mesh_offset)
    verts_placed = mesh.vertices + offset[None, None, :]
    pmin = verts_placed.reshape(-1, 3).min(axis=0)
    pmax = verts_placed.reshape(-1, 3).max(axis=0)

    # wake box (physical coords), as in the reference (reference: domain.jl:40-54)
    L = params.reference_length
    wk_lo = np.array(
        [
            pmax[0] - 0.1 * L,
            (pmin[1] + pmax[1]) / 2 - (pmax[1] - pmin[1]) * cfg.wake_width_factor / 2,
            (pmin[2] + pmax[2]) / 2 - (pmax[2] - pmin[2]) * cfg.wake_height_factor / 2,
        ]
    )
    wk_hi = np.array(
        [
            pmax[0] + L * cfg.wake_length,
            (pmin[1] + pmax[1]) / 2 + (pmax[1] - pmin[1]) * cfg.wake_width_factor / 2,
            (pmin[2] + pmax[2]) / 2 + (pmax[2] - pmin[2]) * cfg.wake_height_factor / 2,
        ]
    )

    # `margin` counts 8-cell blocks, like the reference's halo margin
    # (reference: domain_topology.jl:54-133).  NOTE the reference's
    # halo-block + sibling-octet machinery covers 2-3x more volume at fine
    # levels than this tight box (its Re10M L2 holds 0.88M cells vs 0.28M
    # here); the VALIDATION.md coverage study measured long-run Cd with
    # tight boxes, reference-matched coverage (margin 5) and octet-aligned
    # boxes — the means agree with the reference within sampling
    # uncertainty in all three, tight boxes matching best (+0.6% at Re10M),
    # so the cheaper tight box is the default and `refinement.margin` is
    # the coverage knob.
    margin_cells = cfg.refinement_margin * 8  # block margin, in cells

    patches: List[PatchLevel] = []
    prev: Optional[PatchLevel] = None
    for lvl in range(1, num_levels + 1):
        scale = 2 ** (lvl - 1)
        dx = params.dx_coarse / scale
        dom = (params.nx_coarse * scale, params.ny_coarse * scale, params.nz_coarse * scale)

        if lvl == 1:
            lo = np.zeros(3, np.int64)
            hi = np.asarray(dom, np.int64)
        else:
            blo = np.floor(pmin / dx).astype(np.int64) - margin_cells
            bhi = np.ceil(pmax / dx).astype(np.int64) + margin_cells
            if cfg.wake_enabled:
                blo = np.minimum(blo, np.floor(wk_lo / dx).astype(np.int64) - margin_cells // 2)
                bhi = np.maximum(bhi, np.ceil(wk_hi / dx).astype(np.int64) + margin_cells // 2)
            # parent containment: the fine ghost at lo-1 needs parent cells
            # down to (lo-1)//2 - 1, so keep 2+ parent cells of margin unless
            # the face sits on the domain boundary.
            plo = np.asarray(prev.lo, np.int64)
            phi = plo + np.asarray(prev.interior, np.int64)
            blo = np.maximum(blo, 2 * (plo + 2))
            bhi = np.minimum(bhi, 2 * (phi - 2))
            # clip to domain; snap to even so patches stay sibling-aligned
            blo = np.maximum(blo, 0) // 2 * 2
            bhi = np.minimum(bhi, np.asarray(dom, np.int64))
            bhi = (bhi + 1) // 2 * 2
            lo, hi = blo, bhi

        interior = tuple(int(v) for v in (hi - lo))
        padded = (_ceil(interior[0], max(x_multiple, 1)), interior[1], interior[2])
        face_bc = []
        for f in range(6):
            ax, side = FACE_AXIS[f], FACE_SIDE[f]
            at_domain = (lo[ax] == 0) if side == 0 else (hi[ax] == dom[ax])
            face_bc.append(DOMAIN_FACE_BC[f] if at_domain or lvl == 1 else BC_INTERFACE)

        # --- static fields over the patch box (reuse dense builders with
        # vertices shifted into patch-local coordinates) ---
        verts_local = verts_placed - (lo.astype(np.float64) * dx)[None, None, :]
        obstacle = voxelize_dense(verts_local, dx, interior)
        active = np.ones(interior, bool)
        obstacle = flood_fill_dense(obstacle, active, 0)

        gx, gy, gz = np.meshgrid(
            lo[0] + np.arange(interior[0]),
            lo[1] + np.arange(interior[1]),
            lo[2] + np.arange(interior[2]),
            indexing="ij",
        )
        sponge = sponge_for_cells(
            (gx + 0.5) * dx,
            (gy + 0.5) * dx,
            (gz + 0.5) * dx,
            params.domain_size,
            cfg.sponge_thickness,
            cfg.symmetric_analysis,
        )
        if cfg.wall_model_enabled:
            wall = wall_distance_dense(obstacle, dx)
        else:
            wall = np.full(interior, 100.0, np.float32)

        from ..domain.builder import should_use_bouzidi

        bouzidi = None
        if should_use_bouzidi(lvl, num_levels, cfg):
            bouzidi = compute_bouzidi(verts_local, dx, interior, active)
            log.info("[Bouzidi] level %d: %d boundary cells", lvl, bouzidi.n_boundary_cells)

        patch = PatchLevel(
            level_id=lvl,
            dx=dx,
            tau=float(params.tau_levels[lvl - 1]),
            lo=tuple(int(v) for v in lo),
            interior=interior,
            padded=padded,
            face_bc=tuple(face_bc),
            obstacle=_pad_field(obstacle, padded, True),
            sponge=_pad_field(sponge, padded, np.float32(0.0)),
            wall_dist=_pad_field(wall, padded, np.float32(100.0)),
            bouzidi=bouzidi,
        )
        log.info(
            "[Patch] level %d: lo=%s interior=%s padded=%s (%.2fM cells, %.0f%% pad)",
            lvl, patch.lo, interior, padded,
            patch.n_cells / 1e6, 100 * (patch.n_padded / patch.n_cells - 1),
        )
        patches.append(patch)
        prev = patch
    return patches
