"""Re10M Cd margin study: realization scatter around the window-matched run.

Round 3 validated Re10M at dev −4.7% of the ±5% band on a SINGLE
realization (VALIDATION.md); this quantifies whether that margin is real or
sampling luck:

  r1: the validated configuration, 12000 steps (window-matched re-run)
  r2: an independent realization — u_lattice 0.03 -> 0.0295 perturbs the
      discrete trajectory (same Re, same resolution; dt shifts 1.7%) so the
      chaotic wake decorrelates from r1
  r3: r1's configuration run long (target 24000 steps) — the last-2000
      window at every 2000-step offset from 14000 on gives the
      within-realization window scatter

Prints per-run window Cd means and the combined mean ± CI.  r3's
consecutive same-realization windows are autocorrelated, so they collapse
into ONE realization-level sample (their mean) before the CI; with n this
small the CI uses the Student-t quantile for n-1 dof, not z=1.96.  The
reference's own late window is 0.332 ± 0.023 (reference:
RESULTS_SPHERE_RE10M.txt:285-288).

Usage: python tools/re10m_ci.py [r1 r2 r3]
"""

import csv
import os
import statistics as st
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from validate_spheres import REGIMES, run_regime, window_stats  # noqa: E402


def main():
    which = sys.argv[1:] or ["r1", "r2", "r3"]
    ref_cd = REGIMES["10M"]["ref_cd"]
    samples = []
    if "r1" in which:
        cd, sd = run_regime("10M", tag="_r1")
        samples.append(("r1@12000", cd, sd))
    if "r2" in which:
        cd, sd = run_regime(
            "10M", tag="_r2",
            overrides={"advanced.numerics.u_lattice": 0.0295},
        )
        samples.append(("r2@12000", cd, sd))
    if "r3" in which:
        run_regime("10M", tag="_r3", steps=24000)
        forces = "/tmp/val_10M_r3/RESULTS/forces.csv"
        # start at 14000: r3 is a deterministic replay of r1's trajectory,
        # so its 12000-step window IS r1's sample (verified bit-identical)
        r3_windows = []
        for last in range(14000, 24001, 2000):
            try:
                cd, sd, cl, n = window_stats(forces, last)
            except Exception:
                break  # run ended before this window
            r3_windows.append(cd)
            print(f"[WINDOW r3@{last}] Cd = {cd:.4f} +- {sd:.4f} "
                  f"(dev {(cd-ref_cd)/ref_cd*100:+.1f}%)", flush=True)
        if r3_windows:
            # consecutive same-realization windows are autocorrelated:
            # collapse them into ONE realization-level sample for the CI
            samples.append(("r3(window-mean)", st.mean(r3_windows),
                            st.stdev(r3_windows) if len(r3_windows) > 1
                            else 0.0))
    cds = [c for _, c, _ in samples]
    if len(cds) > 1:
        # Student-t quantile at 95% two-sided for n-1 dof (z=1.96 is
        # optimistically narrow at realization counts this small)
        t95 = {1: 12.71, 2: 4.30, 3: 3.18, 4: 2.78, 5: 2.57, 6: 2.45,
               7: 2.36}.get(len(cds) - 1, 2.0)
        mean, sdev = st.mean(cds), st.stdev(cds)
        half = t95 * sdev / len(cds) ** 0.5
        print(f"\n[RE10M CI] n={len(cds)} realization-samples: Cd "
              f"{mean:.4f} +- {half:.4f} (95% t-CI of the mean, "
              f"t={t95}; sample sd {sdev:.4f}) | ref {ref_cd:.4f} | "
              f"mean dev {(mean-ref_cd)/ref_cd*100:+.1f}%", flush=True)
    for tag, cd, sd in samples:
        print(f"  {tag}: {cd:.4f} +- {sd:.4f} ({(cd-ref_cd)/ref_cd*100:+.1f}%)")


if __name__ == "__main__":
    main()
