"""Diagnostic: wing forces via surface-stress mapping vs an independent
control-volume momentum balance on the finest level."""
import sys, os, shutil, yaml
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np
import jax, jax.numpy as jnp
from open_ludwig.jax_setup import setup_jax_cache
setup_jax_cache()
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
from open_ludwig.geometry import load_mesh
from open_ludwig.scaling import compute_domain_params
from open_ludwig.solver_dense import (
    build_patch_statics, init_patch_state, make_batch_runner_dense)
from open_ludwig.ops.forces import (
    compute_aerodynamics, compute_aerodynamics_mem, make_force_context_dense,
    make_mem_context)
from open_ludwig.ops import storage

name = sys.argv[1] if len(sys.argv) > 1 else "wing_5deg"
res = int(sys.argv[2]) if len(sys.argv) > 2 else 48
steps = int(sys.argv[3]) if len(sys.argv) > 3 else 12000
U = float(sys.argv[4]) if len(sys.argv) > 4 else 0.15

src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "CASES", name)
out = f"/tmp/cv_{name}"
shutil.rmtree(out, ignore_errors=True); os.makedirs(out)
shutil.copy(os.path.join(src, "wing.stl"), os.path.join(out, "wing.stl"))
cfg = yaml.safe_load(open(os.path.join(src, "config.yaml")))
cfg["basic"]["surface_resolution"] = res
cfg["basic"]["flow"]["velocity"] = U
cfg["advanced"]["high_re"]["wall_model"]["enabled"] = False
cfg["basic"]["simulation"]["steps"] = steps
cfg["basic"]["simulation"]["ramp_steps"] = steps // 4
yaml.safe_dump(cfg, open(os.path.join(out, "config.yaml"), "w"), sort_keys=False)
c = load_case_config(out)
tri = load_mesh(c.stl_path, scale=c.stl_scale)
params = compute_domain_params(c, tri.min_bounds, tri.max_bounds)
patches = build_patches(c, tri, params)
for p in patches:
    print("level", p.level_id, "padded", p.padded, "interior", p.interior, "lo", p.lo, "tau", f"{p.tau:.6f}")
statics = build_patch_statics(c, patches)
states = [init_patch_state(p, c.precision) for p in patches]
run = make_batch_runner_dense(c, params, patches, statics)
B = 2000
for t0 in range(0, steps, B):
    states = run(states, np.int32(t0 + 1), B)
jax.block_until_ready(states[0]["rho"])

# mapping-based forces
fctx = make_force_context_dense(tri, patches[-1], params)
fr = compute_aerodynamics(states[-1], fctx)
print(f"[mapping] Cd={fr.Cd:+.4f} Cl={fr.Cl:+.4f} Fx={fr.Fx:+.3e} Fz={fr.Fz:+.3e}")

# momentum-exchange forces across the fluid/solid interface (the method
# the CV study motivated: no wall-normal sampling at all)
mctx = make_mem_context(patches[-1], params, tri,
                        g_storage=storage.normalize_precision(c.precision)
                        == storage.STORE_BF16)
if mctx is not None:
    fm = compute_aerodynamics_mem(states[-1], mctx)
    print(f"[mom-ex ] Cd={fm.Cd:+.4f} Cl={fm.Cl:+.4f} "
          f"Fx={fm.Fx:+.3e} Fz={fm.Fz:+.3e} "
          f"({mctx.n_links} links)")
else:
    print("[mom-ex ] no obstacle cells on the finest level")

# control-volume momentum balance on the finest level
from open_ludwig.diagnostics import control_volume_force

print("vel_scale", params.velocity_scale, "dx_fine",
      params.dx_levels[patches[-1].level_id - 1])
rho_phys = c.fluid_density
F = control_volume_force(states[-1], patches[-1], params, rho_phys, margin=2)
qA = 0.5 * rho_phys * U * U * c.reference_area
print(f"[CV] F = {F} N -> Cd={F[0]/qA:+.4f} Cl={F[2]/qA:+.4f}")
