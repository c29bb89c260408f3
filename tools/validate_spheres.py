"""Window-matched Cd validation against the reference's three sphere runs.

Runs the reference's OWN ball1m case (its 20480-triangle STL, read from
/root/reference read-only) at the three validated regimes
(reference: RESULTS_SPHERE_RE{266K,1M,10M}.txt):

  266K: U=4 m/s,   N=25, 6000 steps   -> ref late-window Cd 0.383 +- 0.040
  1M:   U=14.8,    N=25, 12000 steps  -> ref late-window Cd 0.378 +- 0.031
  10M:  U=148,     N=55, 12000 steps  -> ref late-window Cd 0.332 +- 0.023
                        (ball1m bundled CSV, same regime: 0.322 +- 0.021)

Targets are the mean over the last 2000 steps of each reference console log
(extracted with the same 200-step cadence).  The wall model is ON in every
regime, exactly as in the reference runs.

Usage: python tools/validate_spheres.py [266K] [1M] [10M]
Writes /tmp/val_<regime>/ with RESULTS/forces.csv and prints the comparison.
"""

import csv
import os
import shutil
import statistics as st
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF_CASE = "/root/reference/CASES/ball1m"
REGIMES = {
    "266K": dict(velocity=4.0, surface_resolution=25, steps=6000,
                 ref_cd=0.3832, ref_sd=0.0397),
    "1M": dict(velocity=14.8, surface_resolution=25, steps=12000,
               ref_cd=0.3780, ref_sd=0.0313),
    "10M": dict(velocity=148.0, surface_resolution=55, steps=12000,
                ref_cd=0.3320, ref_sd=0.0228),
}
WINDOW = 2000  # steps


def make_case(regime: str, out_dir: str, **extra) -> str:
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(REF_CASE, "ball1m.stl"),
                os.path.join(out_dir, "ball1m.stl"))
    with open(os.path.join(REF_CASE, "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    r = REGIMES[regime]
    cfg["basic"]["flow"]["velocity"] = r["velocity"]
    cfg["basic"]["surface_resolution"] = r["surface_resolution"]
    cfg["basic"]["simulation"]["steps"] = int(extra.get("steps", r["steps"]))
    cfg["basic"]["simulation"]["ramp_steps"] = 2000
    cfg["basic"]["simulation"]["output_freq"] = 100000  # no VTK during runs
    cfg.setdefault("advanced", {}).setdefault("diagnostics", {})["freq"] = 200
    for k, v in extra.get("overrides", {}).items():
        sec = cfg
        *path, leaf = k.split(".")
        for p in path:
            sec = sec.setdefault(p, {})
        sec[leaf] = v
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return out_dir


def window_stats(forces_csv: str, last_step: int, window: int = WINDOW):
    # bounded on BOTH sides so offset windows into a longer run (re10m_ci
    # r3) measure the window they name, not everything after it
    rows = list(csv.DictReader(open(forces_csv)))
    w = [r for r in rows
         if last_step - window < int(r["Step"]) <= last_step]
    cds = [float(r["Cd"]) for r in w]
    cls = [float(r["Cl"]) for r in w]
    return (st.mean(cds), st.stdev(cds) if len(cds) > 1 else 0.0,
            st.mean(cls), len(w))


def run_regime(regime: str, tag: str = "", **extra):
    from open_ludwig.config import load_case_config
    from open_ludwig.runner import solve_case

    out = f"/tmp/val_{regime}{tag}"
    shutil.rmtree(out, ignore_errors=True)
    make_case(regime, out, **extra)
    cfg = load_case_config(out)
    solve_case(cfg)
    r = REGIMES[regime]
    steps = int(extra.get("steps", r["steps"]))
    cd, sd, cl, n = window_stats(os.path.join(out, "RESULTS", "forces.csv"),
                                 steps)
    dev = (cd - r["ref_cd"]) / r["ref_cd"] * 100
    print(f"[VALIDATE {regime}{tag}] Cd = {cd:.4f} +- {sd:.4f} (Cl {cl:+.3f},"
          f" n={n}) | ref {r['ref_cd']:.4f} +- {r['ref_sd']:.4f} | "
          f"dev {dev:+.1f}%", flush=True)
    return cd, sd


if __name__ == "__main__":
    which = sys.argv[1:] or ["266K", "1M", "10M"]
    for regime in which:
        run_regime(regime)
