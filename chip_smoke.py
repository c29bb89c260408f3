"""Smoke test of the solver on one NVIDIA GPU (or four, with --four-cards).

Run from the root of a checkout on a machine with a CUDA-enabled JAX:

  python chip_smoke.py              # every phase below, one card
  python chip_smoke.py --four-cards # only the x-slab path over four cards,
                                    # compared with one card

Phases, all in this one process (a second JAX process on the card would
fail for want of memory):

  1. environment  JAX version, devices, the card's name and power limit;
                  exits non-zero when JAX's backend is not the GPU.
  2. oracle       one stream-collide step of the finest level of the headline
                  case, at its real shape, with interface, inlet/outlet and
                  mirror faces, WALE and the wall model, against the float64
                  oracle (tests/reference_impl.py); ghost planes come from the
                  production interface code, from a random parent state.
  3. main path    the headline case (sphere Re~1M, 3 levels, bf16 g-storage,
                  Bouzidi, WALE, wall model, wake box) through
                  runner.solve_case for a few hundred coarse steps, its
                  outputs checked; then a few coarse steps of the same case
                  on the GPU and on the CPU device from one random state.
  4. large state  a single-level box of ~64M cells for 20 coarse steps, with
                  its compiled memory analysis and peak bytes.
  5. blocks       a tiny case on the sparse 8^3-block layout.

Any failed check raises, and the script exits non-zero.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

import json
import os
import sys
import tempfile
import time

# one process drives the card: give it most of the memory for the large box
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "tests"))  # the float64 oracle

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import build_sphere, card_line, require_gpu, site_updates  # noqa: E402
from open_ludwig import lattice as lat  # noqa: E402
from open_ludwig.jax_setup import setup_jax_cache  # noqa: E402

# tolerances of the oracle phase, against the float64 oracle:
#  - f32 storage: float32 arithmetic over one step, the bound the CPU test
#    of the same comparison uses (tests/test_dense.py);
#  - bf16 g-storage: the output f is rounded to bf16 in g = f - w space,
#    |g| <~ 0.1 w, so one bf16 ulp (2^-8 relative) is ~1e-4 of f.
ORACLE_TOL = {"float32": 2e-5, "bfloat16": 2e-3}
# GPU against CPU on the headline case over a few coarse steps: bf16 storage
# rounds each step's output, and a last-bit difference in the f32 arithmetic
# (summation order, fused multiply-adds) can move a value across a bf16
# rounding boundary — one ulp of g, which the next steps carry into rho and u
GPU_CPU_TOL = 1e-3
# four cards against one, f32 storage: the slabs run the one-card arithmetic
# (the kernel is per cell, the interface einsums run replicated), so f and u
# should agree to the bit; the sharded force sum adds in another order
FOUR_CARD_TOL = 1e-5
# the ~64M-cell single-level box (reference: BASELINE.md, the 400^3 row)
BOX_RES = 45
# the compiled step's temporaries may exceed solver_dense.hbm_bytes_per_cell's
# transient bytes by this factor (XLA's own scratch beside the A-B pair)
MEM_FORMULA_SLACK = 1.25


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            print(f"== phase {name}", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"== phase {name}: ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return wrap


def check(cond, what):
    if not cond:
        raise AssertionError(what)


@phase("environment")
def environment():
    print(f"jax {jax.__version__}; devices: {jax.devices()}")
    require_gpu()
    print(f"card (name, power limit): {card_line()}", flush=True)


def _oracle_case(case, precision, face_bc, seed):
    """One step of the finest level at its real shape, with `face_bc`,
    against the float64 oracle.  Returns the max errors of f, rho, u."""
    import dataclasses

    from reference_impl import naive_iface_plane, naive_step

    from open_ludwig.core.patch import BC_INTERFACE
    from open_ludwig.ops import storage
    from open_ludwig.ops.dense_step import (
        build_iface_mm_plan,
        extract_endpoint_slabs,
        interface_planes_pair_mm,
    )
    from open_ludwig.solver_dense import build_patch_statics, level_step_for

    cfg = case["cfg"].with_overrides(precision=precision,
                                     inlet_turbulence_intensity=0.05)
    parent = case["levels"][-2]
    child = dataclasses.replace(case["levels"][-1], face_bc=tuple(face_bc),
                                bouzidi=None)
    rng = np.random.default_rng(seed)
    X, Y, Z = child.interior
    # sprinkle wall distances so the wall model is active in the fluid
    wall = child.wall_dist.copy()
    near = rng.random(wall.shape) < 0.05
    wall[near] = rng.uniform(0.6, 4.0, near.sum())
    child = dataclasses.replace(child, wall_dist=wall)

    def stored(shape, amp):
        f = lat.W.reshape((27,) + (1,) * len(shape)) * (
            1.0 + amp * rng.standard_normal((27,) + shape))
        return storage.encode_f(jnp.asarray(f, jnp.float32), precision)

    def parent_state():
        return {
            "f": stored(parent.padded, 0.05),
            "rho": jnp.asarray(1.0 + 0.02 * rng.standard_normal(parent.padded),
                               jnp.float32),
            "vel": jnp.asarray(0.03 * rng.standard_normal((3,) + parent.padded),
                               jnp.float32),
        }

    p_old, p_new = parent_state(), parent_state()
    f0 = stored(child.padded, 0.05)
    v0 = jnp.asarray(0.02 * rng.standard_normal((3,) + child.padded), jnp.float32)
    static = build_patch_statics(cfg, [child])[0]

    # sub-step B (temporal weight 0.5) of the production ghost planes
    plan = build_iface_mm_plan(child, parent)
    planes = interface_planes_pair_mm(
        plan, child, parent, extract_endpoint_slabs(plan, p_old),
        extract_endpoint_slabs(plan, p_new), True)
    iface = {fc: pl[1] for fc, pl in planes.items()}
    step = jax.jit(level_step_for()(cfg, child))
    t0 = time.perf_counter()
    f1, r1, v1 = step(f0, v0, jnp.float32(cfg.u_lattice), jnp.int32(7),
                      static, iface)
    f1 = np.asarray(storage.decode_f(f1))
    print(f"  {precision}: GPU step compiled and ran in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def f64(st):
        return {"f": np.asarray(storage.decode_f(st["f"]), np.float64),
                "rho": np.asarray(st["rho"], np.float64),
                "vel": np.asarray(st["vel"], np.float64)}

    scale = float(np.clip((child.tau - 0.5) / (parent.tau - 0.5), 0.01, 100.0))
    o64, n64 = f64(p_old), f64(p_new)
    ref_iface = {
        fc: naive_iface_plane(fc, child.lo, child.interior, child.padded,
                              parent.lo, [o64, n64], (0.5, 0.5), scale)
        for fc in range(6) if face_bc[fc] == BC_INTERFACE
    }
    # the XLA step reads y/z planes x-rows first; the oracle reads (27, A, B)
    for fc, pl in iface.items():
        got = np.asarray(pl, np.float64)
        got = got if fc // 2 == 0 else got.transpose(1, 0, 2)
        err = np.abs(got - ref_iface[fc]).max()
        print(f"  {precision}: ghost plane face {fc}: max |err| {err:.3e}")
        check(err <= ORACLE_TOL[precision], f"face {fc} plane error {err}")
    t0 = time.perf_counter()
    f_ref, r_ref, v_ref = naive_step(
        np.asarray(storage.decode_f(f0), np.float64)[:, :X, :Y, :Z],
        np.asarray(v0, np.float64)[:, :X, :Y, :Z],
        child.obstacle[:X, :Y, :Z], child.sponge[:X, :Y, :Z].astype(np.float64),
        wall[:X, :Y, :Z].astype(np.float64),
        u_inlet=np.float64(np.float32(cfg.u_lattice)), t_seed=7, tau=child.tau,
        c_wale=cfg.c_wale, nu_sgs=cfg.nu_sgs_background,
        inlet_turb=cfg.inlet_turbulence_intensity, wall_model=True,
        sponge_blend=cfg.sponge_blend_distributions, face_bc=face_bc,
        iface={fc: pl[:, :, :] for fc, pl in ref_iface.items()}, lo=child.lo,
    )
    print(f"  {precision}: float64 oracle in {time.perf_counter() - t0:.1f} s")
    errs = (
        np.abs(f1[:, :X, :Y, :Z] - f_ref).max(),
        np.abs(np.asarray(r1)[:X, :Y, :Z] - r_ref).max(),
        np.abs(np.asarray(v1)[:, :X, :Y, :Z] - v_ref).max(),
    )
    return errs


@phase("oracle")
def oracle(case):
    from open_ludwig.core.patch import (
        BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET,
    )

    I = BC_INTERFACE
    faces = {
        "float32": (BC_INLET, BC_OUTLET, BC_MIRROR_Y, I, I, BC_MIRROR_Z),
        "bfloat16": (I, BC_OUTLET, I, BC_MIRROR_Y, BC_MIRROR_Z, I),
    }
    print(f"  finest level interior {case['levels'][-1].interior}")
    out = {}
    for i, (prec, fb) in enumerate(faces.items()):
        ef, er, ev = _oracle_case(case, prec, fb, seed=100 + i)
        tol = ORACLE_TOL[prec]
        print(f"  {prec}: max |err| f {ef:.3e}, rho {er:.3e}, u {ev:.3e} "
              f"(bound {tol:g})", flush=True)
        check(max(ef, er, ev) <= tol, f"{prec} step off the oracle")
        out[prec] = (ef, er, ev)
    return out


@phase("main path")
def main_path(res=25, steps=400, devices=None):
    from open_ludwig.runner import solve_case
    from open_ludwig.solver_dense import build_patch_statics, make_batch_runner_dense

    case_dir = tempfile.mkdtemp()
    case = build_sphere(surface_resolution=res, case_dir=case_dir, steps=steps,
                        diag_freq=100)
    cfg = case["cfg"].with_overrides(output_freq=steps)
    print("  levels: " + "; ".join(
        f"L{p.level_id} {p.interior} = {p.n_cells} cells" for p in case["levels"]))
    t0 = time.perf_counter()
    res = solve_case(cfg)
    print(f"  solve_case: {steps} coarse steps in {time.perf_counter() - t0:.1f} s "
          f"(compile included); {res.mlups:.1f} MLUPS-ref end to end")
    out = cfg.output_path
    files = sorted(os.listdir(out))
    print(f"  outputs: {files}")
    for want in ("convergence.csv", "forces.csv"):
        check(want in files, f"missing {want}")
    for prefix in ("flow_", "surface_"):
        check(any(f.startswith(prefix) and f.endswith(".vtu") for f in files),
              f"missing {prefix}*.vtu")
    st = res.final_stats
    print(f"  coarse rho in [{st.rho_min:.5f}, {st.rho_max:.5f}], "
          f"Cd {res.final_forces.Cd:.4f}")
    check(0.9 < st.rho_min and st.rho_max < 1.1, "rho out of (0.9, 1.1)")
    check(np.isfinite(res.final_forces.Cd), "Cd not finite")

    # the same case, GPU against the CPU device, from one random state
    rng = np.random.default_rng(5)
    from open_ludwig.ops import storage

    def perturbed(p):
        f = lat.W.reshape(27, 1, 1, 1) * (
            1.0 + 0.02 * rng.standard_normal((27,) + p.padded))
        return {
            "f": np.asarray(storage.encode_f(jnp.asarray(f, jnp.float32),
                                             cfg.precision)),
            "rho": np.ones(p.padded, np.float32),
            "vel": (0.01 * rng.standard_normal((3,) + p.padded)).astype(np.float32),
        }

    init = [perturbed(p) for p in case["levels"]]
    n = 3
    finals = []
    devices = devices or (jax.devices("gpu")[0], jax.devices("cpu")[0])
    for dev in devices:
        t0 = time.perf_counter()
        with jax.default_device(dev):
            statics = build_patch_statics(cfg, case["levels"])
            run = make_batch_runner_dense(cfg, case["params"], case["levels"],
                                          statics)
            states = run([{k: jnp.asarray(v) for k, v in s.items()} for s in init],
                         np.int32(150), n)
            finals.append(jax.device_get(
                [{k: s[k] for k in ("rho", "vel")} for s in states]))
        print(f"  {n} coarse steps on {dev.platform} in "
              f"{time.perf_counter() - t0:.1f} s (compile included)", flush=True)
    d = 0.0
    for p, a, b in zip(case["levels"], *finals):
        X, Y, Z = p.interior
        for key in ("rho", "vel"):
            d = max(d, float(np.abs(np.asarray(a[key])[..., :X, :Y, :Z]
                                    - np.asarray(b[key])[..., :X, :Y, :Z]).max()))
    print(f"  GPU vs CPU after {n} coarse steps: max |d rho|, |d u| {d:.3e} "
          f"(bound {GPU_CPU_TOL:g})")
    check(d <= GPU_CPU_TOL, "GPU and CPU runs differ")


@phase("large state")
def large_state(res=BOX_RES):
    from open_ludwig.solver_dense import hbm_bytes_per_cell, make_batch_runner_dense

    case = build_sphere(surface_resolution=res, num_levels=1, steps=100)
    (p,) = case["levels"]
    prec = case["cfg"].precision
    print(f"  box {p.interior} = {p.n_cells / 1e6:.2f}M cells, bf16 g-storage")
    run = make_batch_runner_dense(case["cfg"], case["params"], case["levels"],
                                  case["statics"])
    states = run.seed(case["states"])
    del case["states"]
    t0 = time.perf_counter()
    compiled = run.jitted.lower(states, run.arrs, np.int32(1), 10).compile()
    mem = compiled.memory_analysis()
    print(f"  compiled in {time.perf_counter() - t0:.1f} s; memory analysis: "
          f"{mem}", flush=True)
    # the planner's per-cell transient bytes against the compiled step's
    want = p.n_padded * (hbm_bytes_per_cell(prec) - hbm_bytes_per_cell(prec, False))
    print(f"  step temporaries {mem.temp_size_in_bytes} B = "
          f"{mem.temp_size_in_bytes / want:.3f} x the planner's "
          f"{want} B ({want / p.n_padded:.0f} B/cell)", flush=True)
    check(mem.temp_size_in_bytes <= MEM_FORMULA_SLACK * want,
          "step temporaries exceed the planner's formula")
    states = compiled(states, run.arrs, np.int32(1))  # warm-up window
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    states = compiled(states, run.arrs, np.int32(11))
    jax.block_until_ready(states)
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0)
    mlups = site_updates(case["levels"]) * 10 / dt / 1e6
    rho = np.asarray(states[0]["rho"])
    print(f"  20 coarse steps; peak_bytes_in_use {peak} "
          f"({peak / p.n_cells:.1f} B/cell); timed window of 10 steps "
          f"{dt:.3f} s = {mlups:.1f} MLUPS-su on {card_line()}", flush=True)
    check(np.isfinite(rho).all() and 0.9 < rho.min() and rho.max() < 1.1,
          "box rho out of (0.9, 1.1)")


@phase("blocks layout")
def blocks_layout():
    from open_ludwig.cases import make_case_sphere
    from open_ludwig.config import load_case_config
    from open_ludwig.runner import solve_case

    d = tempfile.mkdtemp()
    make_case_sphere(d, "1M", surface_resolution=10, num_levels=2, steps=20,
                     ramp_steps=10, output_freq=1000, diag_freq=10)
    cfg = load_case_config(d).with_overrides(layout="blocks")
    res = solve_case(cfg)
    st = res.final_stats
    print(f"  blocks: {res.total_cells} cells, rho in "
          f"[{st.rho_min:.5f}, {st.rho_max:.5f}]")
    check(np.isfinite(st.rho_min) and 0.9 < st.rho_min and st.rho_max < 1.1,
          "blocks layout rho out of (0.9, 1.1)")


@phase("four cards")
def four_cards():
    from open_ludwig.ops.forces import compute_aerodynamics, make_force_context_dense
    from open_ludwig.parallel.patch_shard import (
        make_batch_runner_sharded,
        make_x_mesh,
        shard_states,
        shard_statics,
    )
    from open_ludwig.solver_dense import make_batch_runner_dense

    check(len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}")
    case = build_sphere(precision="float32", x_multiple=4)
    mesh = make_x_mesh(4)
    ids = {d.id for d in mesh.devices.flat}
    check(len(ids) == 4, f"slabs not on four distinct cards: {mesh.devices}")
    print(f"  mesh {mesh.devices.tolist()}; levels " + "; ".join(
        f"L{p.level_id} {p.padded}" for p in case["levels"]))
    n = 20
    fctx = make_force_context_dense(case["mesh"], case["levels"][-1],
                                    case["params"])

    def twice(name, run, states):
        """n coarse steps (compile included), then n more timed; returns
        the states after the first n on the host, and their Cd."""
        t0 = time.perf_counter()
        first = run(states, np.int32(1), n)
        jax.block_until_ready(first)
        setup = time.perf_counter() - t0
        kept = jax.device_get(first)
        cd = compute_aerodynamics(first[-1], fctx).Cd
        t1 = time.perf_counter()
        jax.block_until_ready(run(first, np.int32(1 + n), n))
        dt = time.perf_counter() - t1
        print(f"  {name}: {n} coarse steps in {setup:.1f} s (compile "
              f"included); {n} more in {dt:.4f} s = "
              f"{site_updates(case['levels']) * n / dt / 1e6:.1f} MLUPS-su",
              flush=True)
        return kept, cd

    s4, cd4 = twice("4 cards", make_batch_runner_sharded(
        case["cfg"], case["params"], case["levels"],
        shard_statics(case["statics"], case["levels"], mesh), mesh),
        shard_states(case["states"], mesh))
    s1, cd1 = twice("1 card", make_batch_runner_dense(
        case["cfg"], case["params"], case["levels"], case["statics"]),
        [dict(s) for s in case["states"]])
    d = 0.0
    for p, a, b in zip(case["levels"], s4, s1):
        X, Y, Z = p.interior
        for key in ("f", "vel"):
            d = max(d, float(np.abs(np.asarray(a[key])[..., :X, :Y, :Z]
                                    - np.asarray(b[key])[..., :X, :Y, :Z]).max()))
    print(f"  4 cards vs 1: max |d f|, |d u| {d:.3e}; |d Cd| {abs(cd4 - cd1):.3e} "
          f"(Cd {cd1:.6f}; bound {FOUR_CARD_TOL:g})")
    check(d <= FOUR_CARD_TOL and abs(cd4 - cd1) <= FOUR_CARD_TOL,
          "four cards differ from one")


def main(argv):
    setup_jax_cache()
    environment()
    if "--four-cards" in argv:
        four_cards()
    else:
        case = build_sphere()
        oracle(case)
        main_path()
        large_state()
        blocks_layout()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
