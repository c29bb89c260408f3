"""Force mapping/integration, VTK writer, and checkpoint tests."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from open_ludwig.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from open_ludwig.config import OutputFields
from open_ludwig.domain import topology as topo
from open_ludwig.domain.builder import LevelGeometry, _dense_to_blocks
from open_ludwig.io.vtk import export_flow_vtu, export_surface_vtu, write_vtu
from open_ludwig.ops.forces import ForceContext, compute_aerodynamics


def _dense_geo(dims, obstacle_d, tau=0.55, dx=0.1):
    mask = np.ones(dims, bool)
    coords = topo.blocks_from_mask(mask)
    ptr = topo.build_block_pointer(coords, dims)
    nt = topo.build_neighbor_table(coords, ptr)
    X, Y, Z = [d * 8 for d in dims]
    return LevelGeometry(
        1, dx, 1.0, tau, dims, coords, ptr, nt,
        _dense_to_blocks(obstacle_d, coords),
        np.zeros((len(coords), 512), np.float32),
        np.full((len(coords), 512), 100.0, np.float32),
        None,
    )


def test_force_single_triangle_analytic():
    """One triangle with outward normal +x mapped to a known fluid cell:
    check pressure and shear against hand-computed values."""
    # context arrays built by hand (bypasses the search)
    rho_phys, vel_scale = 1.225, 100.0
    p_scale = rho_phys * vel_scale**2
    tau = 0.56
    nu_lat = (tau - 0.5) / 3
    n_tri = 1
    area = 0.02
    normal = np.array([[1.0], [0.0], [0.0]], np.float32)
    center = np.array([[1.0], [2.0], [3.0]], np.float32)
    mc = np.array([0.5, 2.0, 3.0], np.float32)

    ctx = ForceContext(
        cell_idx=jnp.asarray(np.array([5], np.int32)),
        wall_dist=jnp.asarray(np.array([0.8], np.float32)),
        found=jnp.asarray(np.array([True])),
        normals=jnp.asarray(normal),
        areas=jnp.asarray(np.array([area], np.float32)),
        centers=jnp.asarray(center),
        moment_center=jnp.asarray(mc),
        tau_molecular=tau,
        pressure_scale=float(p_scale),
        q_inf=0.5 * rho_phys * 10.0**2,
        area_ref=1.0,
        chord_ref=1.0,
        symmetric=False,
    )
    rho = np.ones(16, np.float32)
    rho[5] = 1.06
    vel = np.zeros((3, 16), np.float32)
    vel[:, 5] = [0.0, 0.04, 0.03]  # purely tangential to +x normal
    state = {"rho": jnp.asarray(rho), "vel": jnp.asarray(vel)}
    fr = compute_aerodynamics(state, ctx)

    p_expect = (1.06 - 1) / 3 * p_scale
    assert fr.pressure_map[0] == pytest.approx(p_expect, rel=1e-5)
    ut = np.hypot(0.04, 0.03)
    tau_mag = 1.06 * nu_lat * ut / 0.8 * p_scale
    assert fr.shear_map[1, 0] == pytest.approx(tau_mag * 0.04 / ut, rel=1e-4)
    # Fx = -p * nx * A (pressure only, shear has no x component)
    assert fr.Fx == pytest.approx(-p_expect * area, rel=1e-5)
    assert fr.Fx_viscous == pytest.approx(0.0, abs=1e-9)
    # moment about mc: r = (0.5, 0, 0); M = r x F -> My = rz*Fx - rx*Fz, etc.
    Fy = tau_mag * 0.04 / ut * area
    Fz = tau_mag * 0.03 / ut * area
    assert fr.Mz == pytest.approx(0.5 * Fy, rel=1e-4)
    assert fr.My == pytest.approx(-0.5 * Fz, rel=1e-4)
    # coefficients
    assert fr.Cd == pytest.approx(fr.Fx / (0.5 * 1.225 * 100), rel=1e-6)


def test_force_symmetry_doubling():
    ctx_kw = dict(
        cell_idx=jnp.asarray(np.array([0], np.int32)),
        wall_dist=jnp.asarray(np.array([0.5], np.float32)),
        found=jnp.asarray(np.array([True])),
        normals=jnp.asarray(np.array([[1.0], [0.0], [0.0]], np.float32)),
        areas=jnp.asarray(np.array([1.0], np.float32)),
        centers=jnp.asarray(np.zeros((3, 1), np.float32)),
        moment_center=jnp.asarray(np.zeros(3, np.float32)),
        tau_molecular=0.55,
        pressure_scale=1000.0,
        q_inf=10.0,
        area_ref=1.0,
        chord_ref=1.0,
    )
    rho = jnp.asarray(np.array([1.03], np.float32))
    vel = jnp.asarray(np.array([[0.0], [0.02], [0.0]], np.float32))
    st = {"rho": rho, "vel": vel}
    f_full = compute_aerodynamics(st, ForceContext(symmetric=False, **ctx_kw))
    f_sym = compute_aerodynamics(st, ForceContext(symmetric=True, **ctx_kw))
    assert f_sym.Fx == pytest.approx(2 * f_full.Fx, rel=1e-6)
    assert f_sym.Fy == 0.0
    assert f_sym.Mx == 0.0 and f_sym.Mz == 0.0


def test_vtu_writer_roundtrip(tmp_path):
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    conn = np.array([[0, 1, 2]], np.int32)
    path = str(tmp_path / "t.vtu")
    write_vtu(path, pts, conn, 5, {"val": np.array([3.14], np.float32)})
    root = ET.parse(path).getroot()
    assert root.attrib["type"] == "UnstructuredGrid"
    piece = root.find(".//Piece")
    assert piece.attrib["NumberOfPoints"] == "3"
    assert piece.attrib["NumberOfCells"] == "1"
    names = [d.attrib.get("Name") for d in root.findall(".//DataArray")]
    assert "val" in names and "connectivity" in names


def test_vtu_compressed_data_decodes(tmp_path):
    """The zlib-compressed DataArray payload round-trips: UInt32[4] block
    header base64-encoded separately from the compressed block (VTK XML
    compressed format, the reference's WriteVTK default)."""
    import base64
    import struct
    import zlib

    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    conn = np.array([[0, 1, 2]], np.int32)
    val = np.array([3.14, -1.0, 0.5], np.float32)[:1]
    path = str(tmp_path / "c.vtu")
    write_vtu(path, pts, conn, 5, {"val": val})
    root = ET.parse(path).getroot()
    assert root.attrib.get("compressor") == "vtkZLibDataCompressor"
    da = [d for d in root.findall(".//DataArray") if d.attrib.get("Name") == "val"][0]
    txt = da.text.strip()
    nb, bs, lbs, cs = struct.unpack("<4I", base64.b64decode(txt[:24]))
    assert nb == 1 and bs == lbs == val.nbytes
    raw = zlib.decompress(base64.b64decode(txt[24:]))
    assert len(raw) == bs
    np.testing.assert_allclose(np.frombuffer(raw, np.float32), val)


def test_flow_export_skips_refined_blocks(tmp_path):
    # two levels: coarse 1x1x1 block fully covered by 8 fine children
    coarse = _dense_geo((1, 1, 1), np.zeros((8, 8, 8), bool))
    fine = _dense_geo((2, 2, 2), np.zeros((16, 16, 16), bool), dx=0.05)
    fine.level_id = 2
    states = [
        {"rho": jnp.ones((1, 512)), "vel": jnp.zeros((3, 1, 512))},
        {"rho": jnp.ones((8, 512)), "vel": jnp.zeros((3, 8, 512))},
    ]
    path = str(tmp_path / "flow.vtu")
    export_flow_vtu(path, [coarse, fine], states, OutputFields())
    root = ET.parse(path).getroot()
    # only the 8 fine blocks are exported (coarse block fully refined)
    assert root.find(".//Piece").attrib["NumberOfCells"] == str(8 * 512)


def test_surface_export(tmp_path):
    verts = np.zeros((2, 3, 3))
    verts[0] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    verts[1] = [[0, 0, 1], [1, 0, 1], [0, 1, 1]]
    path = str(tmp_path / "surf.vtu")
    export_surface_vtu(
        path, verts, np.tile([0, 0, 1.0], (2, 1)), np.array([0.5, 0.5]),
        np.array([10.0, 0.0]), np.zeros((3, 2)),
    )
    root = ET.parse(path).getroot()
    assert root.find(".//Piece").attrib["NumberOfCells"] == "2"
    names = [d.attrib.get("Name") for d in root.findall(".//DataArray")]
    for want in ("Pressure_Pa", "ShearMagnitude_Pa", "MappingQuality", "Area_m2"):
        assert want in names


def test_checkpoint_roundtrip(tmp_path):
    states = [
        {
            "f": jnp.asarray(np.random.rand(27, 2, 512).astype(np.float32)),
            "rho": jnp.ones((2, 512), jnp.float32),
            "vel": jnp.zeros((3, 2, 512), jnp.float32),
        }
    ]
    d = str(tmp_path / "ck")
    save_checkpoint(d, 123, states)
    save_checkpoint(d, 456, states)
    assert latest_checkpoint(d).endswith("00000456.npz")
    step, loaded = load_checkpoint(latest_checkpoint(d))
    assert step == 456
    assert np.allclose(np.asarray(loaded[0]["f"]), np.asarray(states[0]["f"]))


def test_checkpoint_async_streaming_equivalence(tmp_path):
    """The streaming writer (chunked fetch + incremental zip members +
    background disk write) must produce a byte-compatible npz: async and
    sync saves of the same multi-level state load back identically, bf16
    and f32 alike, with the chunked path actually exercised (chunk size
    shrunk below one array)."""
    from open_ludwig import checkpoint as ckpt

    rng = np.random.default_rng(3)
    states = [
        {
            "f": jnp.asarray(
                rng.standard_normal((27, 24, 16, 128)), jnp.bfloat16),
            "rho": jnp.asarray(rng.standard_normal((24, 16, 128)),
                               jnp.float32),
            "vel": jnp.asarray(rng.standard_normal((3, 24, 16, 128)),
                               jnp.float32),
            "_ifsl": {"x": jnp.zeros((2,))},  # derived carry: must be skipped
        },
        {
            "f": jnp.asarray(rng.standard_normal((27, 8, 8, 128)),
                             jnp.float32),
            "rho": jnp.ones((8, 8, 128), jnp.float32),
            "vel": jnp.zeros((3, 8, 8, 128), jnp.float32),
        },
    ]
    old_chunk = ckpt._CHUNK_BYTES
    ckpt._CHUNK_BYTES = 64 * 1024  # force many chunks per member
    try:
        d1, d2 = str(tmp_path / "sync"), str(tmp_path / "async")
        p1 = ckpt.save_checkpoint(d1, 7, states, async_write=False)
        p2 = ckpt.save_checkpoint(d2, 7, states, async_write=True)
        ckpt.wait_pending()
    finally:
        ckpt._CHUNK_BYTES = old_chunk
    s1, l1 = ckpt.load_checkpoint(p1)
    s2, l2 = ckpt.load_checkpoint(p2)
    assert s1 == s2 == 7
    for a, b, src in zip(l1, l2, states):
        for key in ("f", "rho", "vel"):
            ga = np.asarray(a[key], np.float32)
            gb = np.asarray(b[key], np.float32)
            assert a[key].dtype == src[key].dtype
            assert np.array_equal(ga, gb)
            assert np.array_equal(ga, np.asarray(src[key], np.float32))


def test_flow_export_with_vorticity(tmp_path):
    from open_ludwig.core.patch import PatchLevel
    from open_ludwig.io.vtk import export_flow_vtu_patches

    p = PatchLevel(
        1, 0.1, 0.55, (0, 0, 0), (8, 8, 8), (8, 8, 128),
        (0, 1, 2, 2, 3, 3),
        np.zeros((8, 8, 128), bool),
        np.zeros((8, 8, 128), np.float32),
        np.full((8, 8, 128), 100.0, np.float32),
    )
    rng = np.random.default_rng(0)
    states = [{
        "rho": jnp.asarray(np.ones((8, 8, 128), np.float32)),
        "vel": jnp.asarray(rng.random((3, 8, 8, 128)).astype(np.float32) * 0.01),
    }]
    path = str(tmp_path / "f.vtu")
    export_flow_vtu_patches(path, [p], states, OutputFields(vorticity=True))
    root = ET.parse(path).getroot()
    names = [d.attrib.get("Name") for d in root.findall(".//DataArray")]
    assert "Vorticity" in names


def test_vorticity_blocks_seam_free():
    """A linear shear u_x = a*y spanning a 2x2x1 block grid has constant
    |curl u| = a everywhere — the old intra-block-roll formulation fabricated
    O(u) vorticity sheets at every 8-cell block face."""
    from open_ludwig.diagnostics import vorticity_blocks_host
    from open_ludwig.domain.builder import _dense_to_blocks

    dims = (2, 2, 1)
    X, Y, Z = 16, 16, 8
    a = 0.01
    vel_d = np.zeros((3, X, Y, Z), np.float32)
    vel_d[0] = a * np.arange(Y, dtype=np.float32)[None, :, None]
    coords = topo.blocks_from_mask(np.ones(dims, bool))
    vel_b = np.stack([_dense_to_blocks(vel_d[c], coords) for c in range(3)])
    w = vorticity_blocks_host(vel_b, coords, dims)
    np.testing.assert_allclose(w, a, rtol=1e-5)


def test_surface_loads_csv(tmp_path):
    from open_ludwig.io.csv_out import export_surface_loads_csv

    path = str(tmp_path / "loads.csv")
    export_surface_loads_csv(
        path,
        centers=np.zeros((2, 3)),
        normals=np.tile([0, 0, 1.0], (2, 1)),
        areas=np.array([0.5, 0.25]),
        pressure=np.array([10.0, -5.0]),
        shear=np.zeros((3, 2)),
        mesh_offset=(1.0, 2.0, 3.0),
    )
    lines = open(path).read().splitlines()
    assert lines[0].startswith("triangle_id,cx,cy,cz,nx,ny,nz,area_m2,pressure_Pa")
    assert len(lines) == 3


def test_pressure_extrapolation_improves_wall_sampling(tmp_path):
    """On a synthetic radial pressure field p(r) = p_w + g*(r - R) around a
    sphere, the wall pressure is known exactly; the two-point wall-normal
    extrapolation (advanced.forces.extrapolate) must recover it better than
    the reference's single nearest-cell sample."""
    import jax.numpy as jnp

    from open_ludwig.cases import make_case_sphere
    from open_ludwig.config import load_case_config
    from open_ludwig.core.patch import build_patches
    from open_ludwig.geometry import load_mesh
    from open_ludwig.ops.forces import make_force_context_dense
    from open_ludwig.scaling import compute_domain_params

    d = str(tmp_path)
    make_case_sphere(d, "1M", surface_resolution=16, num_levels=1, steps=1,
                     ramp_steps=1, output_freq=100, diag_freq=100,
                     wake_enabled=False)
    cfg = load_case_config(d)
    tri = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, tri.min_bounds, tri.max_bounds)
    patch = build_patches(cfg, tri, params)[-1]

    # synthetic rho: radial gradient about the sphere center (domain coords)
    center = (np.asarray(tri.min_bounds) + np.asarray(tri.max_bounds)) / 2 \
        + np.asarray(params.mesh_offset)
    XS, YS, ZS = patch.padded
    dx = patch.dx
    lo = np.asarray(patch.lo)
    gx = (np.arange(XS)[:, None, None] + lo[0] + 0.5) * dx
    gy = (np.arange(YS)[None, :, None] + lo[1] + 0.5) * dx
    gz = (np.arange(ZS)[None, None, :] + lo[2] + 0.5) * dx
    r = np.sqrt((gx - center[0]) ** 2 + (gy - center[1]) ** 2
                + (gz - center[2]) ** 2)
    R = 0.5 * (tri.max_bounds[0] - tri.min_bounds[0])
    rho_w, grad = 1.02, -0.08  # wall value and radial slope (per meter)
    state = {
        "rho": jnp.asarray((rho_w + grad * (r - R)).astype(np.float32)),
        "vel": jnp.zeros((3, XS, YS, ZS), jnp.float32),
    }
    p_wall = (rho_w - 1.0) / 3.0 * params.rho_physical \
        * params.velocity_scale**2

    errs = {}
    for extrap in (False, True):
        ctx = make_force_context_dense(tri, patch, params,
                                       extrapolate=extrap)
        res = compute_aerodynamics(state, ctx)
        found = np.asarray(ctx.found)
        errs[extrap] = np.abs(res.pressure_map[found] - p_wall).mean()
    # extrapolation must cut the mean wall-pressure error substantially
    assert errs[True] < 0.6 * errs[False], errs


def test_momentum_exchange_matches_numpy_reference(tmp_path, rng):
    """Momentum-exchange integration (advanced.forces.method:
    momentum_exchange; re-derived from the dead method at reference
    src/forces/global.jl:15-148 as a flux balance across the obstacle-mask
    interface, see MEMContext): the jitted gather/segment-sum pipeline must
    equal a direct numpy loop over the fluid/solid links — per link
    (f_j(x_f) + f_jbar(x_f + c_j)) c_j, moments about the moment center at
    the link midpoint, nearest-triangle attribution."""
    import jax.numpy as jnp

    from open_ludwig import lattice as lat
    from open_ludwig.cases import make_case_sphere
    from open_ludwig.config import load_case_config
    from open_ludwig.core.patch import build_patches
    from open_ludwig.geometry import load_mesh
    from open_ludwig.ops.forces import (
        compute_aerodynamics_mem,
        make_mem_context,
    )
    from open_ludwig.scaling import compute_domain_params

    d = str(tmp_path)
    make_case_sphere(d, "1M", surface_resolution=14, num_levels=1, steps=1,
                     ramp_steps=1, output_freq=100, diag_freq=100,
                     wake_enabled=False)
    cfg = load_case_config(d)
    tri = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, tri.min_bounds, tri.max_bounds)
    patch = build_patches(cfg, tri, params)[-1]

    ctx = make_mem_context(patch, params, tri, g_storage=True)
    assert ctx is not None
    assert ctx.n_links > 100
    # a closed body's rest-state flux must vanish (uniform-pressure closure)
    assert np.abs(ctx.rest_F).max() < 1e-9

    XS, YS, ZS = patch.padded
    f = (0.01 * rng.standard_normal((27, XS, YS, ZS))).astype(np.float32)
    res = compute_aerodynamics_mem({"f": jnp.asarray(f)}, ctx)

    # --- numpy reference straight from the obstacle mask ---
    X, Y, Z = patch.interior
    obs = np.asarray(patch.obstacle)[:X, :Y, :Z]
    F = np.zeros(3)
    M = np.zeros(3)
    F_tri = np.zeros((3, tri.n_triangles))
    mc = np.asarray(params.moment_center, np.float64)
    lo = np.asarray(patch.lo, np.float64)
    from scipy.spatial import cKDTree

    kd = cKDTree(tri.centers + np.asarray(params.mesh_offset)[None, :])
    bidx = np.argwhere(obs)
    lo_b = np.maximum(bidx.min(0) - 1, 0)
    hi_b = np.minimum(bidx.max(0) + 2, [X, Y, Z])
    for gx in range(lo_b[0], hi_b[0]):
        for gy in range(lo_b[1], hi_b[1]):
            for gz in range(lo_b[2], hi_b[2]):
                if obs[gx, gy, gz]:
                    continue
                for k in range(27):
                    cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
                    if cx == cy == cz == 0:
                        continue
                    nx, ny, nz = gx + cx, gy + cy, gz + cz
                    if not (0 <= nx < X and 0 <= ny < Y and 0 <= nz < Z):
                        continue
                    if not obs[nx, ny, nz]:
                        continue
                    c = np.array([cx, cy, cz], np.float64)
                    w = float(lat.W[k])
                    # g-storage: stored value + w = f
                    f_out = np.float64(f[k, gx, gy, gz]) + w
                    f_in = np.float64(f[int(lat.OPP[k]), nx, ny, nz]) + w
                    dF = (f_out + f_in) * c
                    F += dF
                    mid = (np.array([gx, gy, gz], np.float64) + lo + 0.5
                           + 0.5 * c) * patch.dx
                    M += np.cross(mid - mc, dF)
                    t = int(kd.query(mid)[1])
                    F_tri[:, t] += dF
    F *= params.force_scale
    M *= params.force_scale
    F_tri *= params.force_scale
    if params.symmetric:
        F = np.array([2 * F[0], 0.0, 2 * F[2]])
        M = np.array([0.0, 2 * M[1], 0.0])

    got = np.array([res.Fx, res.Fy, res.Fz])
    scale = np.abs(F).max() + 1e-12
    assert np.abs(got - F).max() / scale < 1e-4, (got, F)
    gotM = np.array([res.Mx, res.My, res.Mz])
    mscale = np.abs(M).max() + 1e-12
    assert np.abs(gotM - M).max() / mscale < 1e-4, (gotM, M)
    assert res.force_map.shape == (3, tri.n_triangles)
    np.testing.assert_allclose(res.force_map, F_tri, rtol=2e-3,
                               atol=1e-6 * scale)
    # coefficients consistent with the integrals
    q_inf = 0.5 * params.rho_physical * params.u_physical**2
    assert abs(res.Cd - res.Fx / (q_inf * params.reference_area)) < 1e-9
