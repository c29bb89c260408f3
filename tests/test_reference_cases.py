"""The reference's six bundled cases run end-to-end through this engine.

Each case's config.yaml + STL (reference: CASES/*/config.yaml) is copied to a
tmp dir and run unmodified except for CI-scale overrides (resolution, steps).
This exercises the full pipeline — reference YAML schema, binary STL parse of
irregular multi-thousand-triangle geometry (bunny 5k, Bucker 6k, wings 63k
triangles), domain sizing, voxelize + flood fill + Bouzidi ray cast, stepping,
forces — on every geometry the reference ships (BASELINE.json's configs list
names Stanford_bunny explicitly).
"""

import os
import shutil

import numpy as np
import pytest

from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
from open_ludwig.geometry import load_mesh
from open_ludwig.runner import solve_case
from open_ludwig.scaling import compute_domain_params

REF_CASES = "/root/reference/CASES"
ALL_CASES = [
    "cube1m", "ball1m", "Stanford_bunny", "Bucker", "Wing_0_deg", "Wing_5_deg",
]

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_CASES), reason="reference CASES not available"
)


def _copy_case(name, tmp_path):
    src = os.path.join(REF_CASES, name)
    dst = tmp_path / name
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("RESULTS"))
    os.chmod(dst, 0o755)
    for f in os.listdir(dst):
        os.chmod(dst / f, 0o644)
    return str(dst)


@pytest.mark.parametrize("name", ALL_CASES)
def test_reference_case_builds(name, tmp_path):
    """Unmodified config + STL through config -> mesh -> params -> patches."""
    case_dir = _copy_case(name, tmp_path)
    cfg = load_case_config(case_dir)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    assert mesh.n_triangles > 0
    assert np.all(mesh.max_bounds > mesh.min_bounds)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    assert params.num_levels >= 1
    assert params.re_number > 0
    # patch build at a CI-scale resolution (same code path, smaller grids)
    small = cfg.with_overrides(surface_resolution=12, num_levels=2)
    params_s = compute_domain_params(small, mesh.min_bounds, mesh.max_bounds)
    patches = build_patches(small, mesh, params_s)
    assert sum(p.n_cells for p in patches) > 0
    # the finest level carries Bouzidi q-values for the geometry
    assert patches[-1].bouzidi is not None
    assert patches[-1].bouzidi.n_boundary_cells > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", ALL_CASES)
def test_reference_case_steps(name, tmp_path):
    """Each reference case steps a few iterations and produces finite
    diagnostics + forces."""
    case_dir = _copy_case(name, tmp_path)
    cfg = load_case_config(case_dir).with_overrides(
        surface_resolution=10,
        num_levels=2,
        steps=4,
        ramp_steps=8,
        output_freq=1000,
        diag_freq=4,
        checkpoint_freq=0,
        async_depth=4,
    )
    res = solve_case(cfg)
    assert res.final_stats is not None
    assert np.isfinite(res.final_stats.rho_min)
    assert 0.2 < res.final_stats.rho_min <= 1.5
    if cfg.forces_enabled:
        assert res.final_forces is not None
        assert np.isfinite(res.final_forces.Cd)
