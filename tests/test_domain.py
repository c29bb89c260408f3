"""Domain construction tests: topology invariants, voxelizer on known shapes,
flood fill of watertight interiors, sponge profile, wall distances, Bouzidi q
against an analytic sphere."""

import numpy as np
import pytest

from open_ludwig.config import CaseConfig
from open_ludwig.domain import topology as topo
from open_ludwig.domain.bouzidi import compute_bouzidi
from open_ludwig.domain.builder import build_domain, setup_case
from open_ludwig.domain.fields import sponge_for_cells, wall_distance_dense
from open_ludwig.domain.voxelize import flood_fill_dense, voxelize_dense
from open_ludwig.geometry import make_cube, make_icosphere, save_binary_stl
from open_ludwig.scaling import compute_domain_params


def test_dilate26():
    m = np.zeros((5, 5, 5), bool)
    m[2, 2, 2] = True
    d = topo.dilate26(m)
    assert d.sum() == 27
    assert d[1:4, 1:4, 1:4].all()


def test_sibling_completion():
    m = np.zeros((4, 4, 4), bool)
    m[1, 1, 1] = True  # octet (0..1)^3
    c = topo.complete_siblings(m)
    assert c[:2, :2, :2].all()
    assert c.sum() == 8


def test_halo_and_parent_coverage():
    m = np.zeros((8, 8, 8), bool)
    m[4, 4, 4] = True
    out = topo.add_halo_with_siblings(m, 2)
    # after closure every active block's sibling octet is complete
    out = topo.ensure_parent_coverage(out)
    par_ids = np.argwhere(out) // 2
    for p in np.unique(par_ids, axis=0):
        child = out[2 * p[0] : 2 * p[0] + 2, 2 * p[1] : 2 * p[1] + 2, 2 * p[2] : 2 * p[2] + 2]
        assert child.all()


def test_neighbor_table_roundtrip():
    dims = (3, 3, 3)
    m = np.ones(dims, bool)
    coords = topo.blocks_from_mask(m)
    ptr = topo.build_block_pointer(coords, dims)
    nt = topo.build_neighbor_table(coords, ptr)
    # center block sees all 27 neighbors (including itself at d=13)
    center = ptr[1, 1, 1]
    assert (nt[center] >= 0).all()
    assert nt[center, 13] == center
    # corner block has exactly 8 present (2x2x2 corner incl itself)
    corner = ptr[0, 0, 0]
    assert (nt[corner] >= 0).sum() == 8


def test_voxelize_cube():
    # unit cube centered in a 32^3 grid at dx = 1/8: shell cells ring the surface
    dx = 1.0 / 8
    verts = make_cube(1.0, center=(2.0, 2.0, 2.0))
    obs = voxelize_dense(verts, dx, (32, 32, 32))
    assert obs.any()
    # the exact interior (well inside) is NOT marked by the shell test
    assert not obs[16, 16, 16]
    # cells far outside are not marked
    assert not obs[2, 2, 2]
    # shell thickness ~1-2 cells around the ±0.5 faces (faces at 1.5 and 2.5)
    gz = np.argwhere(obs[:, 16, 16]).ravel()
    assert gz.min() >= 9 and gz.max() <= 22


def test_flood_fill_cube_interior():
    dx = 1.0 / 8
    verts = make_cube(1.0, center=(2.0, 2.0, 2.0))
    obs = voxelize_dense(verts, dx, (32, 32, 32))
    active = np.ones((32, 32, 32), bool)
    filled = flood_fill_dense(obs, active, 0)
    assert filled[16, 16, 16]  # interior now solid
    assert not filled[2, 2, 2]  # exterior fluid
    # fill count equals interior volume (roughly (6 cells)^3 after shell)
    interior = filled & ~obs
    assert 4**3 <= interior.sum() <= 7**3


def test_sponge_profile():
    L = (10.0, 8.0, 8.0)
    px = np.linspace(0.05, 9.95, 100)
    py = np.full(100, 4.0)
    pz = np.full(100, 4.0)
    s = sponge_for_cells(px, py, pz, L, 0.10, symmetric=False)
    # outlet sponge: strength 1.0 at the far x face, ramping from x=8.5
    assert s[-1] > 0.9
    assert s[np.searchsorted(px, 5.0)] == 0.0
    # inlet sponge small
    assert 0 < s[0] <= 0.05
    # symmetric case: no y_min sponge
    s_sym = sponge_for_cells(
        np.full(10, 5.0), np.linspace(0.01, 0.3, 10), np.full(10, 4.0), L, 0.10, True
    )
    assert (s_sym == 0).all()
    s_asym = sponge_for_cells(
        np.full(10, 5.0), np.linspace(0.01, 0.3, 10), np.full(10, 4.0), L, 0.10, False
    )
    assert s_asym[0] > 0


def test_wall_distance():
    obs = np.zeros((8, 8, 8), bool)
    obs[4, 4, 4] = True
    dx = 0.1
    wd = wall_distance_dense(obs, dx)
    assert wd[3, 4, 4] == pytest.approx(0.1)
    assert wd[3, 3, 4] == pytest.approx(0.1 * np.sqrt(2), rel=1e-6)
    assert wd[3, 3, 3] == pytest.approx(0.1 * np.sqrt(3), rel=1e-6)
    assert wd[0, 0, 0] == 100.0
    assert wd[4, 4, 4] == 100.0  # obstacle keeps sentinel


def test_bouzidi_sphere_analytic():
    # sphere radius 0.4 at center of a 24^3 grid with dx=1/12: q values along
    # axis directions must match the analytic surface fraction
    dx = 1.0 / 12
    c = (1.0, 1.0, 1.0)
    verts = make_icosphere(0.4, center=c, subdiv=4)
    active = np.ones((24, 24, 24), bool)
    bz = compute_bouzidi(verts, dx, (24, 24, 24), active)
    assert bz.n_boundary_cells > 0
    # pick cells on the +x axis from center: center cell index of sphere center
    # is g=11 (center at (11.5+0.5)*dx=1.0). Walk outward in +x.
    got = {}
    for i in range(bz.n_boundary_cells):
        got[(bz.cell_gx[i], bz.cell_gy[i], bz.cell_gz[i])] = bz.q_map[i]
    # cell just outside the surface along +x: center (1.4583, 0.9583, 0.9583)
    # (cell centers are offset half a cell from the sphere axis).  The -x ray
    # hits the sphere at x = 1 + sqrt(r^2 - dy^2 - dz^2).
    q = got.get((17, 11, 11))
    assert q is not None
    k_minus_x = 12  # c = (-1, 0, 0) -> k = 0 + 3*1 + 9*1 = 12
    cx0, cy0, cz0 = (17 + 0.5) * dx, (11 + 0.5) * dx, (11 + 0.5) * dx
    hit_x = 1.0 + np.sqrt(0.4**2 - (cy0 - 1.0) ** 2 - (cz0 - 1.0) ** 2)
    expect = (cx0 - hit_x) / dx
    assert float(q[k_minus_x]) == pytest.approx(expect, abs=0.02)


def _tiny_case(tmp_path, **over):
    verts = make_icosphere(0.5, subdiv=2)
    stl = tmp_path / "sphere.stl"
    save_binary_stl(str(stl), verts)
    cfg = CaseConfig(
        case_dir=str(tmp_path),
        stl_file="sphere.stl",
        surface_resolution=24,
        num_levels=2,
        reference_area_full_model=np.pi * 0.25,
        reference_chord=1.0,
        reference_length_for_meshing=1.0,
        flow_velocity=10.0,
        u_lattice=0.05,
        steps=10,
        ramp_steps=5,
        output_freq=1000,
        domain_upstream=1.0,
        domain_downstream=1.5,
        domain_lateral=1.0,
        domain_height=1.0,
        boundary_method="bouzidi",
        wall_model_enabled=True,
    ).with_overrides(**over)
    return cfg


def test_build_domain_sphere(tmp_path):
    cfg = _tiny_case(tmp_path)
    mesh, params, levels = setup_case(cfg)
    assert len(levels) == params.num_levels
    l1 = levels[0]
    # level 1 fully dense
    assert l1.n_blocks == np.prod(l1.dims)
    # finest level has obstacle + bouzidi
    fin = levels[-1]
    assert fin.obstacle.any()
    assert fin.bouzidi is not None and fin.bouzidi.n_boundary_cells > 0
    # parent coverage: every fine block's parent active
    coarse_mask = topo.mask_from_blocks(levels[-2].coords, levels[-2].dims)
    par = fin.coords // 2
    assert coarse_mask[par[:, 0], par[:, 1], par[:, 2]].all()
    # sibling octets complete on fine level
    fine_mask = topo.mask_from_blocks(fin.coords, fin.dims)
    pm = fin.coords // 2
    for p in np.unique(pm, axis=0):
        assert fine_mask[
            2 * p[0] : 2 * p[0] + 2, 2 * p[1] : 2 * p[1] + 2, 2 * p[2] : 2 * p[2] + 2
        ].all()
    # wall distances present near the body on the fine level
    assert (fin.wall_dist < 100.0).any()
    # interior of the sphere is solid after flood fill: check a center cell
    # (find block containing domain point of sphere center)
    cx = params.mesh_offset[0]  # sphere center x (mesh centered at origin)
    g = np.array(
        [
            cx / fin.dx,
            (params.mesh_center[1] + params.mesh_offset[1]) / fin.dx,
            (params.mesh_center[2] + params.mesh_offset[2]) / fin.dx,
        ]
    ).astype(int)
    b = g // 8
    bid = fin.block_ptr[b[0], b[1], b[2]]
    if bid >= 0:
        loc = g - b * 8
        flat = loc[2] * 64 + loc[1] * 8 + loc[0]
        assert fin.obstacle[bid, flat]
