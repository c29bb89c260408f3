"""Guard for the wing momentum-exchange force result (VALIDATION.md).

The round-4 headline physics win — live momentum-exchange forces resolving
streamlined-body drag where stress mapping reads the wrong sign (reference
keeps MEM as dead code, reference: src/forces/global.jl:15-148) — was
established by on-hardware tools runs only.  This test pins the machinery
in CI at the cheapest regime that still runs the FULL pipeline on a real
wing flow: laminar Re 1e4 NACA0012 at 5 deg, coarse single-level tunnel,
with an independent control-volume momentum balance of the same flow as
the oracle (diagnostics.control_volume_force — it samples only the far
field, so it shares no near-wall error mode with either surface method).

The assertions check METHOD CONSISTENCY on the voxelized body (MEM flux sum
vs far-field momentum deficit over the same geometry), not physical Cd
accuracy — that lives in tools/wing_cv_probe.py at N=48 (MEM +0.0682 vs CV
+0.0669, 1.9%, VALIDATION.md).
"""

import numpy as np
import pytest

import jax

from open_ludwig.cases import make_case_wing
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
from open_ludwig.diagnostics import control_volume_force
from open_ludwig.geometry import load_mesh
from open_ludwig.ops import storage
from open_ludwig.ops.forces import (
    compute_aerodynamics,
    compute_aerodynamics_mem,
    make_force_context_dense,
    make_mem_context,
)
from open_ludwig.scaling import compute_domain_params
from open_ludwig.solver_dense import (
    build_patch_statics,
    init_patch_state,
    make_batch_runner_dense,
)


@pytest.mark.slow  # ~minutes on CPU: a real (coarse) wing flow to quasi-steady
def test_wing_mem_matches_control_volume(tmp_path):
    make_case_wing(
        str(tmp_path), alpha_deg=5.0,
        surface_resolution=16, num_levels=1,
        velocity=0.15,          # Re = 0.15 * 1 / 1.5e-5 = 1e4 (laminar)
        steps=4000, ramp_steps=800, output_freq=10**9, diag_freq=10**9,
        upstream=1.2, downstream=2.0, lateral=0.9, height=0.9,
        wake_enabled=False,
    )
    cfg = load_case_config(str(tmp_path))
    tri = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, tri.min_bounds, tri.max_bounds)
    patches = build_patches(cfg, tri, params)
    statics = build_patch_statics(cfg, patches)
    states = [init_patch_state(p, cfg.precision) for p in patches]
    run = make_batch_runner_dense(cfg, params, patches, statics)
    steps = cfg.steps
    B = 1000
    for t0 in range(0, steps, B):
        states = run(states, np.int32(t0 + 1), min(B, steps - t0))
    jax.block_until_ready(states[0]["rho"])

    qA = 0.5 * cfg.fluid_density * cfg.velocity**2 * cfg.reference_area

    # far-field oracle: control-volume momentum balance
    F_cv = control_volume_force(
        states[-1], patches[-1], params, cfg.fluid_density, margin=2
    )
    cd_cv = F_cv[0] / qA

    # momentum exchange on the fluid/solid interface
    mctx = make_mem_context(
        patches[-1], params, tri,
        g_storage=storage.normalize_precision(cfg.precision)
        == storage.STORE_BF16,
    )
    assert mctx is not None and mctx.n_links > 0
    fm = compute_aerodynamics_mem(states[-1], mctx)

    # stress mapping (the method MEM supersedes for streamlined bodies)
    fctx = make_force_context_dense(tri, patches[-1], params)
    fr = compute_aerodynamics(states[-1], fctx)

    # flow must have developed: a real drag signal, not noise
    assert np.isfinite([fm.Cd, fm.Cl, fr.Cd, cd_cv]).all()
    assert cd_cv > 0.01, f"CV drag signal missing: {cd_cv}"
    # MEM is sign-correct and tracks the far-field balance
    assert fm.Cd > 0.0, f"MEM drag has the wrong sign: {fm.Cd}"
    assert abs(fm.Cd - cd_cv) <= 0.35 * abs(cd_cv), (
        f"MEM Cd {fm.Cd:+.4f} vs control-volume {cd_cv:+.4f} "
        f"diverged past 35%"
    )
