"""Wing validation: Cl(5 deg) > Cl(0 deg) with plausible Cd.

Runs the bundled NACA0012 wing cases (mirrors of the reference's
CASES/Wing_{0,5}_deg class) at a matched CI-affordable resolution and long
force window, and checks the physics-level ordering the geometry implies:
lift at 5 deg incidence clearly exceeds lift at 0 deg, with |Cd| in a
plausibility band.  The reference ships no wing force targets (no RESULTS
for its wing cases; they are configured for N=1100 production runs), so
ordering + band are the strongest available check — see VALIDATION.md and
tools/wing_cv_probe.py for the quantitative study of what CI-scale wing
force accuracy can and cannot deliver.

Usage: python tools/validate_wing.py [--res 48] [--steps 12000]
"""

import argparse
import csv
import os
import shutil
import statistics as st
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CASES = os.path.join(os.path.dirname(__file__), "..", "CASES")


def run_case(name: str, res: int, steps: int, window: int):
    import yaml

    from open_ludwig.config import load_case_config
    from open_ludwig.runner import solve_case

    src = os.path.join(CASES, name)
    out = f"/tmp/valwing_{name}"
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    shutil.copy(os.path.join(src, "wing.stl"), os.path.join(out, "wing.stl"))
    cfg = yaml.safe_load(open(os.path.join(src, "config.yaml")))
    cfg["basic"]["surface_resolution"] = res
    # Regime notes (all measured, see VALIDATION.md):
    # - res 24 leaves ~3 cells across the 12%-thick section: upper/lower
    #   surface triangles sample shared cells and Cl is meaningless.
    # - laminar Re 1e4 shows the documented low-Re NACA0012 negative-lift
    #   anomaly at small alpha (confirmed here by a control-volume momentum
    #   balance agreeing with the mapped lift) — unusable for an ordering
    #   check.
    # - WMLES at Re 6.7e5, res 48: lift ordering robustly positive; the
    #   absolute slope is far below lifting-line (under-resolved circulation
    #   at CI scale — the reference's own wing case targets N=1100 and
    #   ships no force results to compare against).
    cfg["basic"]["flow"]["velocity"] = 10.0
    cfg["advanced"]["high_re"]["wall_model"]["enabled"] = True
    cfg["basic"]["simulation"]["steps"] = steps
    cfg["basic"]["simulation"]["ramp_steps"] = min(2000, steps // 4)
    cfg["basic"]["simulation"]["output_freq"] = 10 * steps
    cfg.setdefault("advanced", {}).setdefault("diagnostics", {})["freq"] = 100
    yaml.safe_dump(cfg, open(os.path.join(out, "config.yaml"), "w"),
                   sort_keys=False)
    solve_case(load_case_config(out))
    rows = list(csv.DictReader(open(os.path.join(out, "RESULTS", "forces.csv"))))
    w = [r for r in rows if int(r["Step"]) > steps - window]
    cl = [float(r["Cl"]) for r in w]
    cd = [float(r["Cd"]) for r in w]
    return (st.mean(cl), st.stdev(cl) if len(cl) > 1 else 0.0,
            st.mean(cd), len(w))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--steps", type=int, default=12000)
    args = ap.parse_args()
    window = args.steps // 2

    import numpy as np

    cl0, s0, cd0, n0 = run_case("wing_0deg", args.res, args.steps, window)
    cl5, s5, cd5, n5 = run_case("wing_5deg", args.res, args.steps, window)
    import math

    dcl_dalpha = (cl5 - cl0) / math.radians(5.0)
    print(f"[WING 0deg] Cl = {cl0:+.4f} +- {s0:.4f}  Cd = {cd0:.4f} (n={n0})")
    print(f"[WING 5deg] Cl = {cl5:+.4f} +- {s5:.4f}  Cd = {cd5:.4f} (n={n5})")
    print(f"[WING] dCl/dalpha = {dcl_dalpha:.2f} /rad  (2pi = 6.28)")
    ok = cl5 > cl0 + 2.0 * max(s0, s5) / max(n0, 1) ** 0.5
    # slope reported for the record; the absolute value is resolution-
    # limited at CI scale (see module docstring)
    cd_ok = 0.002 < abs(cd0) < 0.25 and 0.002 < abs(cd5) < 0.25
    print(f"[WING] Cl ordering: {'PASS' if ok else 'FAIL'} | "
          f"Cd plausibility: {'PASS' if cd_ok else 'FAIL'}")
    return 0 if (ok and cd_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
