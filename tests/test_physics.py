"""Physics regression tests: uniform-flow steady state, symmetric half-model
force doubling, and multi-level interface consistency on a quiescent field."""

import numpy as np
import pytest

import jax.numpy as jnp

from open_ludwig import lattice as lat
from open_ludwig.cases import make_case_sphere
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import (
    BC_INLET, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel, build_patches,
)
from open_ludwig.geometry import load_mesh, make_icosphere, save_binary_stl
from open_ludwig.ops.dense_step import dense_stream_collide
from open_ludwig.scaling import compute_domain_params
from open_ludwig.solver_dense import (
    build_patch_statics,
    init_patch_state,
    make_coarse_step_dense,
)


def _empty_patch(interior, tau=0.56):
    X, Y, Z = interior
    XS, YS, ZS = X, -(-Y // 8) * 8, -(-Z // 128) * 128
    return PatchLevel(
        1, 1.0, tau, (0, 0, 0), interior, (XS, YS, ZS),
        (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z),
        np.zeros((XS, YS, ZS), bool),
        np.zeros((XS, YS, ZS), np.float32),
        np.full((XS, YS, ZS), 100.0, np.float32),
    )


@pytest.mark.slow  # compile-heavy on CPU; full suite still runs it
def test_uniform_flow_develops():
    """Empty tunnel driven by the inlet: the interior converges toward the
    inlet velocity with rho ~ 1 (mass/momentum transport sanity)."""
    p = _empty_patch((24, 8, 120))
    static = {
        "obstacle": jnp.asarray(p.obstacle.reshape(-1)),
        "sponge": jnp.asarray(p.sponge.reshape(-1)),
        "wall_dist": jnp.asarray(p.wall_dist.reshape(-1)),
        "bouzidi": None,
    }
    f = jnp.broadcast_to(jnp.asarray(lat.W)[:, None, None, None],
                         (27,) + p.padded).astype(jnp.float32)
    v = jnp.zeros((3,) + p.padded, jnp.float32)
    u_in = jnp.float32(0.05)
    for t in range(300):
        f, rho, v = dense_stream_collide(
            f, v, u_in, jnp.int32(t), static, p,
            c_wale=0.5, nu_sgs_background=0.0, inlet_turbulence=0.0,
            wall_model=False, sponge_blend=False)
    X, Y, Z = p.interior
    ux = np.asarray(v)[0, :X, :Y, :Z]
    rho_i = np.asarray(rho)[:X, :Y, :Z]
    assert abs(ux.mean() - 0.05) < 0.005, ux.mean()
    assert abs(rho_i.mean() - 1.0) < 0.01
    assert np.abs(np.asarray(v)[1:, :X, :Y, :Z]).max() < 0.01


@pytest.mark.slow  # 274s; interface parity is covered by test_dense mm-parity
def test_multilevel_quiescent_consistency(tmp_path):
    """A 2-level quiescent domain (u_inlet = 0) with an obstacle must stay at
    rest equilibrium through the full coarse-step schedule, including
    interface interpolation and Bouzidi."""
    verts = make_icosphere(0.5, subdiv=2)
    save_binary_stl(str(tmp_path / "s.stl"), verts)
    make_case_sphere(str(tmp_path), "1M", surface_resolution=16, num_levels=2,
                     steps=4, ramp_steps=2, output_freq=100, diag_freq=100,
                     wake_enabled=False, u_lattice=1e-7)
    cfg = load_case_config(str(tmp_path))
    mesh = load_mesh(cfg.stl_path)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    patches = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, patches)
    states = [init_patch_state(p) for p in patches]
    cs = make_coarse_step_dense(cfg, params, patches, statics)
    for t in range(1, 4):
        states = cs(states, jnp.int32(t))
    for st, p in zip(states, patches):
        X, Y, Z = p.interior
        f = np.asarray(st["f"])[:, :X, :Y, :Z]
        assert np.allclose(f, np.asarray(lat.W)[:, None, None, None], atol=1e-5)
        assert np.abs(np.asarray(st["vel"])[:, :X, :Y, :Z]).max() < 1e-5


def test_symmetric_force_doubling_config(tmp_path):
    """symmetric_analysis halves the reference area and places the mesh at
    y=0 (reference: config_loader.jl:129, physics_scaling.jl:130)."""
    from open_ludwig.config import CaseConfig

    verts = make_icosphere(0.5, center=(0.0, 0.26, 0.0), subdiv=2)
    save_binary_stl(str(tmp_path / "s.stl"), verts)
    cfg = CaseConfig(
        case_dir=str(tmp_path), stl_file="s.stl", surface_resolution=16,
        num_levels=1, reference_area_full_model=1.0,
        reference_length_for_meshing=1.0, flow_velocity=10.0, u_lattice=0.05,
        steps=1, ramp_steps=1, output_freq=10, symmetric_analysis=True,
        domain_upstream=1.0, domain_downstream=1.0, domain_lateral=1.0,
        domain_height=1.0,
    )
    assert cfg.reference_area == 0.5
    mesh = load_mesh(cfg.stl_path)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    assert params.symmetric
    # mesh offset keeps the body's own y coordinates (mesh_y = 0)
    assert params.mesh_offset[1] == 0.0
    # domain extends from y=0 upward only
    assert params.domain_size[1] == pytest.approx(
        mesh.max_bounds[1] + 1.0, rel=0.2
    )
