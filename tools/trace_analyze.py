"""Capture a jax.profiler trace of the bench scan and print per-op device
time aggregated by op name.

Usage: python tools/trace_analyze.py [--levels 3] [--res 25] [--n 50]
"""

import argparse
import collections
import glob
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")


def analyze(trace_dir):
    import jax.profiler as jp

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    assert paths, f"no xplane.pb under {trace_dir}"
    pd = jp.ProfileData.from_file(paths[0])
    rows = collections.Counter()
    counts = collections.Counter()
    total = 0.0
    for plane in pd.planes:
        # device planes are named "/device:GPU:<n>"; the rest are host threads
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lname = line.name.lower()
            # kernel lines (one per stream) carry the per-kernel events; skip
            # the step and XLA-module annotation lines, which overlap them
            if "step" in lname or "module" in lname:
                continue
            for ev in line.events:
                dur = ev.duration_ns / 1e3  # us
                name = ev.name
                rows[name] += dur
                counts[name] += 1
                total += dur
    print(f"\ntotal device op-time: {total/1e3:.1f} ms")
    print(f"{'op':70s} {'total us':>10s} {'n':>6s} {'us/call':>8s} {'%':>5s}")
    for name, us in rows.most_common(40):
        print(f"{name[:70]:70s} {us:10.0f} {counts[name]:6d} "
              f"{us/counts[name]:8.1f} {100*us/total:5.1f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--res", type=int, default=25)
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--dir", default="")
    ap.add_argument("--precision", default="float32")
    args = ap.parse_args()

    if args.dir:
        analyze(args.dir)
        return

    import jax

    from open_ludwig.jax_setup import setup_jax_cache

    setup_jax_cache()

    from open_ludwig.cases import make_case_sphere
    from open_ludwig.config import load_case_config
    from open_ludwig.core.patch import build_patches
    from open_ludwig.geometry import load_mesh
    from open_ludwig.scaling import compute_domain_params
    from open_ludwig.solver_dense import (
        build_patch_statics,
        init_patch_state,
        make_batch_runner_dense,
    )

    tmp = tempfile.mkdtemp()
    make_case_sphere(
        tmp, "1M", surface_resolution=args.res, num_levels=args.levels,
        steps=400, ramp_steps=200, output_freq=100000, diag_freq=100000,
        wake_enabled=True,
    )
    cfg = load_case_config(tmp).with_overrides(precision=args.precision)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, levels)
    states = [init_patch_state(p, args.precision) for p in levels]
    run = make_batch_runner_dense(cfg, params, levels, statics)

    states = run(states, np.int32(1), args.n)  # compile + warm
    jax.block_until_ready(states[0]["rho"])

    tdir = tempfile.mkdtemp(prefix="oltrace_")
    jax.profiler.start_trace(tdir)
    t0 = time.time()
    states = run(states, np.int32(args.n + 1), args.n)
    jax.block_until_ready(states[0]["rho"])
    wall = time.time() - t0
    jax.profiler.stop_trace()
    upd = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)
    print(f"traced batch: {wall*1e3:.1f} ms for {args.n} coarse steps "
          f"({upd*args.n/wall/1e6:.0f} MLUPS)  trace={tdir}")
    analyze(tdir)


if __name__ == "__main__":
    main()
