"""MEM resolution-convergence study on the sphere (VERDICT round-4 item 3).

Momentum exchange integrates over the VOXELIZED body, whose staircase
surface sits 0.3-1.4 cells proud of the triangle surface — at N=25 that
read Cd +0.57 where stress mapping read +0.45 (reference measured 0.447,
reference: RESULTS_SPHERE_RE266K.txt:236).  This sweeps N = 25/40/55 at
Re 2.67e5 and reports TIME-AVERAGED MEM vs mapped Cd (instantaneous Cd on
these chaotic flows swings +-0.1-0.3, VALIDATION.md), writing
MEM_CONVERGENCE.json for the validation table.

Usage: python tools/mem_convergence.py [res,res,...] [base_steps]
"""
import json
import os
import sys
import tempfile

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)

import numpy as np

import jax

from open_ludwig.jax_setup import setup_jax_cache

setup_jax_cache()

from open_ludwig.cases import make_case_sphere
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
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

RES = [int(r) for r in (sys.argv[1] if len(sys.argv) > 1 else "25,40,55").split(",")]
BASE_STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 6000
REF_CD = 0.447  # reference: RESULTS_SPHERE_RE266K.txt:236

rows = []
for res in RES:
    steps = int(BASE_STEPS * res / 25)  # same physical time at every N
    tmp = tempfile.mkdtemp()
    make_case_sphere(
        tmp, "266K", surface_resolution=res, num_levels=3, steps=steps,
        ramp_steps=steps // 4, output_freq=10**9, diag_freq=10**9,
    )
    c = load_case_config(tmp)
    tri = load_mesh(c.stl_path, scale=c.stl_scale)
    params = compute_domain_params(c, tri.min_bounds, tri.max_bounds)
    patches = build_patches(c, tri, params)
    statics = build_patch_statics(c, patches)
    states = [init_patch_state(p, c.precision) for p in patches]
    run = make_batch_runner_dense(c, params, patches, statics)

    fctx = make_force_context_dense(tri, patches[-1], params)
    mctx = make_mem_context(
        patches[-1], params, tri,
        g_storage=storage.normalize_precision(c.precision)
        == storage.STORE_BF16,
    )
    assert mctx is not None and mctx.n_links > 0, f"no MEM links at N={res}"
    # transient, then sample forces every `samp` steps over the last 25%
    t_avg0 = int(steps * 0.75)
    samp = max(100, steps // 40)
    cd_map, cd_mem, cl_mem = [], [], []
    t = 0
    while t < steps:
        b = min(samp, steps - t) if t >= t_avg0 else t_avg0 - t
        states = run(states, np.int32(t + 1), b)
        t += b
        if t > t_avg0:
            fr = compute_aerodynamics(states[-1], fctx)
            fm = compute_aerodynamics_mem(states[-1], mctx)
            cd_map.append(float(fr.Cd))
            cd_mem.append(float(fm.Cd))
            cl_mem.append(float(fm.Cl))
    jax.block_until_ready(states[0]["rho"])
    row = {
        "res": res, "steps": steps, "n_samples": len(cd_mem),
        "n_links": int(mctx.n_links),
        "cd_mapped": round(float(np.mean(cd_map)), 4),
        "cd_mem": round(float(np.mean(cd_mem)), 4),
        "cd_mem_std": round(float(np.std(cd_mem)), 4),
        "cl_mem": round(float(np.mean(cl_mem)), 4),
        "mem_vs_mapped_pct": round(
            100 * (np.mean(cd_mem) - np.mean(cd_map))
            / max(abs(np.mean(cd_map)), 1e-9), 1),
        "cd_reference": REF_CD,
    }
    rows.append(row)
    print(json.dumps(row), flush=True)
    with open(os.path.join(_ROOT, "MEM_CONVERGENCE.json"), "w") as f:
        json.dump(rows, f, indent=1)
print("wrote MEM_CONVERGENCE.json")
