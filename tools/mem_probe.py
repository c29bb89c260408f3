"""Diagnostic: stress-mapping vs momentum-exchange vs (optionally) a
control-volume balance on a sphere flow — the MEM cross-check the wing CV
study motivated (VALIDATION.md)."""
import sys, os, shutil, tempfile
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np
import jax
from open_ludwig.jax_setup import setup_jax_cache
setup_jax_cache()
from open_ludwig.cases import make_case_sphere
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
from open_ludwig.geometry import load_mesh
from open_ludwig.scaling import compute_domain_params
from open_ludwig.solver_dense import (
    build_patch_statics, init_patch_state, make_batch_runner_dense)
from open_ludwig.ops.forces import (
    compute_aerodynamics, compute_aerodynamics_mem,
    make_force_context_dense, make_mem_context)
from open_ludwig.ops import storage

res = int(sys.argv[1]) if len(sys.argv) > 1 else 25
steps = int(sys.argv[2]) if len(sys.argv) > 2 else 6000
nlev = int(sys.argv[3]) if len(sys.argv) > 3 else 3

out = tempfile.mkdtemp()
make_case_sphere(out, "266K", surface_resolution=res, num_levels=nlev,
                 steps=steps, ramp_steps=steps // 4, output_freq=10**9,
                 diag_freq=10**9)
c = load_case_config(out)
tri = load_mesh(c.stl_path, scale=c.stl_scale)
params = compute_domain_params(c, tri.min_bounds, tri.max_bounds)
patches = build_patches(c, tri, params)
statics = build_patch_statics(c, patches)
states = [init_patch_state(p, c.precision) for p in patches]
run = make_batch_runner_dense(c, params, patches, statics)
B = 2000
for t0 in range(0, steps, B):
    states = run(states, np.int32(t0 + 1), min(B, steps - t0))
jax.block_until_ready(states[0]["rho"])

fctx = make_force_context_dense(tri, patches[-1], params)
fr = compute_aerodynamics(states[-1], fctx)
print(f"[mapping] Cd={fr.Cd:+.4f} Cl={fr.Cl:+.4f} Fx={fr.Fx:+.3e}")
mctx = make_mem_context(patches[-1], params, tri,
                        g_storage=storage.normalize_precision(c.precision)
                        == storage.STORE_BF16)
if mctx is None:
    print("[mom-ex ] no links"); sys.exit(0)
fm = compute_aerodynamics_mem(states[-1], mctx)
print(f"[mom-ex ] Cd={fm.Cd:+.4f} Cl={fm.Cl:+.4f} Fx={fm.Fx:+.3e} "
      f"({mctx.n_links} links)  rest_F={np.asarray(mctx.rest_F)}")
