"""Cross-validation of the two storage layouts: on a single-level domain the
dense-patch and sparse-block paths simulate the identical dense grid, so their
fields must agree to float32 roundoff after multiple steps."""

import numpy as np
import pytest

import jax.numpy as jnp

from open_ludwig.cases import make_case_sphere
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
from open_ludwig.core.state import build_all
from open_ludwig.domain.builder import setup_case
from open_ludwig.geometry import load_mesh
from open_ludwig.scaling import compute_domain_params
from open_ludwig.solver import make_coarse_step
from open_ludwig.solver_dense import (
    build_patch_statics,
    init_patch_state,
    make_coarse_step_dense,
)

_LF = np.arange(512)
_LX, _LY, _LZ = _LF % 8, (_LF // 8) % 8, _LF // 64


def _blocks_to_dense(blocked, coords, dims):
    X, Y, Z = (d * 8 for d in dims)
    lead = blocked.shape[:-2]
    out = np.zeros(lead + (X, Y, Z), np.asarray(blocked).dtype)
    gx = coords[:, 0, None] * 8 + _LX[None, :]
    gy = coords[:, 1, None] * 8 + _LY[None, :]
    gz = coords[:, 2, None] * 8 + _LZ[None, :]
    out[..., gx, gy, gz] = np.asarray(blocked)
    return out


@pytest.mark.slow  # 115s; both layouts are oracle-checked individually in fast tests
def test_single_level_dense_vs_blocks(tmp_path):
    make_case_sphere(
        str(tmp_path), "1M", surface_resolution=10, num_levels=1, steps=6,
        ramp_steps=3, output_freq=100, diag_freq=100, wake_enabled=False,
        boundary_method="bounce_back", wall_model=True, inlet_turbulence=0.02,
    )
    cfg = load_case_config(str(tmp_path))

    # dense path (XLA step; identical math to the block path's collide)
    mesh = load_mesh(cfg.stl_path)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    patches = build_patches(cfg, mesh, params)
    dstat = build_patch_statics(cfg, patches)
    dstate = [init_patch_state(p) for p in patches]
    cs_d = make_coarse_step_dense(cfg, params, patches, dstat)

    # block path
    _, params_b, levels = setup_case(cfg)
    bstate, bstat = build_all(cfg, params_b, levels)
    cs_b = make_coarse_step(cfg, params_b, bstat)

    for t in range(1, 5):
        dstate = cs_d(dstate, jnp.int32(t))
        bstate = cs_b(bstate, jnp.int32(t))

    p = patches[0]
    X, Y, Z = p.interior
    f_dense = np.asarray(dstate[0]["f"])[:, :X, :Y, :Z]
    f_blocks = _blocks_to_dense(
        np.asarray(bstate[0]["f"]), levels[0].coords, levels[0].dims
    )[:, :X, :Y, :Z]
    d = np.abs(f_dense - f_blocks).max()
    assert d < 5e-6, d
    v_dense = np.asarray(dstate[0]["vel"])[:, :X, :Y, :Z]
    v_blocks = _blocks_to_dense(
        np.asarray(bstate[0]["vel"]), levels[0].coords, levels[0].dims
    )[:, :X, :Y, :Z]
    assert np.abs(v_dense - v_blocks).max() < 5e-6


@pytest.mark.slow  # 374s: compiles the 2-level XLA step twice on CPU
def test_z_pad_tile_invariance(tmp_path):
    """Storage padding is pure layout: a 2-level case stepped unpadded and
    with every level's x-extent padded to a multiple of 8 (the x-slab
    device-count padding) must produce identical interior fields — pad cells
    are obstacle-filled and never feed interior physics, and the interface
    einsum plans encode the same operators for any slab padding."""
    make_case_sphere(
        str(tmp_path), "1M", surface_resolution=8, num_levels=2, steps=4,
        ramp_steps=2, output_freq=100, diag_freq=100, wake_enabled=True,
        wall_model=True, inlet_turbulence=0.02,
    )
    cfg = load_case_config(str(tmp_path))
    mesh = load_mesh(cfg.stl_path)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)

    results = {}
    for tile in (1, 8):
        patches = build_patches(cfg, mesh, params, x_multiple=tile)
        stat = build_patch_statics(cfg, patches)
        state = [init_patch_state(p) for p in patches]
        cs = make_coarse_step_dense(cfg, params, patches, stat)
        for t in range(1, 4):
            state = cs(state, jnp.int32(t))
        results[tile] = (patches, state)
    assert any(p.padded != p.interior for p in results[8][0])

    pa, sa = results[1]
    pb, sb = results[8]
    for lvl in range(2):
        assert pa[lvl].interior == pb[lvl].interior
        X, Y, Z = pa[lvl].interior
        for key in ("f", "rho", "vel"):
            a = np.asarray(sa[lvl][key], np.float32)[..., :X, :Y, :Z]
            b = np.asarray(sb[lvl][key], np.float32)[..., :X, :Y, :Z]
            d = np.abs(a - b).max()
            assert d == 0.0, (lvl, key, d)
