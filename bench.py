"""Headline benchmark: MLUPS-su per card on the sphere Re~1M virtual wind
tunnel.

Mirrors the reference's validated sphere setup (reference:
RESULTS_SPHERE_RE1M.txt:34-44 — N=25 cells/diameter, u_lat=0.03, 3 levels,
here with bf16 g-storage, Bouzidi, WALE, the wall model and the wake box) and
measures sustained million-lattice-SITE-updates/second (MLUPS-su: cells x
2^(level-1) per coarse step — every fine sub-step counts).  The runner's
console prints MLUPS-ref instead (cells x coarse-steps, the reference's own
convention, reference: main.jl:188-190); both are printed here as numbers.

Timing: after one warm-up window (which compiles), each timed window runs
`batch` coarse steps and ends in `jax.block_until_ready`; the result is the
median window.  Compilation is reported separately as set-up time.

Prints the card's name and power limit on an earlier line and ONE JSON line
last.  Any failure raises and exits non-zero; a host with no accelerator is
a failure.

  python bench.py                 # headline case
  python bench.py --box 45        # also a single-level box at resolution 45
"""

import json
import subprocess
import sys
import tempfile
import time

import numpy as np


def card_line() -> str:
    """`nvidia-smi` name and power limit of the card(s), one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}"
        )


def build_sphere(surface_resolution=25, num_levels=3, precision="bfloat16",
                 steps=400, case_dir=None, x_multiple=1, **over):
    """The sphere Re~1M case through the normal builders.  Returns a dict
    with cfg, params, mesh, levels, statics and fresh states."""
    from open_ludwig.cases import make_case_sphere
    from open_ludwig.config import load_case_config
    from open_ludwig.core.patch import build_patches
    from open_ludwig.geometry import load_mesh
    from open_ludwig.scaling import compute_domain_params
    from open_ludwig.solver_dense import build_patch_statics, init_patch_state

    case_dir = case_dir or tempfile.mkdtemp()
    opts = dict(
        surface_resolution=surface_resolution, num_levels=num_levels,
        steps=steps, ramp_steps=200, output_freq=100000, diag_freq=100000,
        wake_enabled=True, precision=precision,
    )
    opts.update(over)
    make_case_sphere(case_dir, "1M", **opts)
    cfg = load_case_config(case_dir)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params, x_multiple=x_multiple)
    statics = build_patch_statics(cfg, levels)
    states = [init_patch_state(p, cfg.precision) for p in levels]
    return dict(cfg=cfg, params=params, mesh=mesh, levels=levels,
                statics=statics, states=states)


def site_updates(levels) -> int:
    """Site updates per coarse step: cells x 2^(level-1)."""
    return sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)


def time_windows(run, states, batch: int, n_windows: int):
    """(states, compile seconds, per-window seconds).  The first window
    compiles and is not timed."""
    import jax

    t0 = time.perf_counter()
    states = run(states, np.int32(1), batch)
    jax.block_until_ready(states)
    compile_s = time.perf_counter() - t0
    windows = []
    for i in range(n_windows):
        t0 = time.perf_counter()
        states = run(states, np.int32(1 + (i + 1) * batch), batch)
        jax.block_until_ready(states)
        windows.append(time.perf_counter() - t0)
    return states, compile_s, windows


def bench_case(case, batch: int, n_windows: int) -> dict:
    import jax

    from open_ludwig.solver_dense import make_batch_runner_dense

    run = make_batch_runner_dense(case["cfg"], case["params"], case["levels"],
                                  case["statics"])
    states, compile_s, windows = time_windows(run, case["states"], batch,
                                              n_windows)
    med = float(np.median(windows))
    cells = sum(p.n_cells for p in case["levels"])
    upd = site_updates(case["levels"])
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    return {
        "cells": cells,
        "site_updates_per_coarse_step": upd,
        "mlups_su": upd * batch / med / 1e6,
        "mlups_ref": cells * batch / med / 1e6,
        "window_s": windows,
        "batch": batch,
        "compile_s": compile_s,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "rho_min": float(states[0]["rho"][: case["levels"][0].interior[0]].min()),
    }


def main(argv):
    import jax

    from open_ludwig.jax_setup import setup_jax_cache

    setup_jax_cache()
    require_gpu()
    print(f"card: {card_line()}", flush=True)
    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    head = bench_case(build_sphere(), batch=200, n_windows=5)
    print(f"# headline: {json.dumps(head)}", flush=True)
    out.update(metric="MLUPS-su per card, sphere Re1M, 3 levels, bf16 "
               "g-storage (median of 5 x 200 coarse steps)",
               value=head["mlups_su"], value_ref=head["mlups_ref"],
               unit="MLUPS")
    if "--box" in argv:
        res = int(argv[argv.index("--box") + 1])
        box = bench_case(build_sphere(surface_resolution=res, num_levels=1,
                                      steps=100), batch=20, n_windows=3)
        print(f"# box res {res}: {json.dumps(box)}", flush=True)
        out["box"] = {"res": res, "cells": box["cells"],
                      "mlups_su": box["mlups_su"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
