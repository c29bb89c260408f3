"""Case driver and multi-case batch runner.

Equivalent of the reference's solve_main / run_all_cases (reference:
main.jl:54-274), re-structured around on-device scan batches: the host only
wakes up at diagnostics / VTK / checkpoint boundaries; everything between is
one jitted lax.scan (the reference instead syncs the device every level-step).
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import jax
import numpy as np

from . import checkpoint as ckpt
from .config import CaseConfig, load_batch_list, load_case_config
from .core.state import build_all, hbm_report
from .diagnostics import check_stability, compute_flow_stats
from .domain.builder import setup_case
from .geometry import TriMesh
from .io.csv_out import (
    append_convergence,
    append_forces,
    print_force_summary,
    walltime_str,
    write_convergence_header,
    write_forces_header,
)
from .io.vtk import export_flow_vtu, export_flow_vtu_patches, export_surface_vtu
from .ops.forces import (
    ForceContext,
    compute_aerodynamics,
    compute_aerodynamics_mem,
    make_force_context,
    make_force_context_dense,
    make_mem_context,
)
from .solver import make_batch_runner
from .solver_dense import (
    build_patch_statics,
    init_patch_state,
    make_batch_runner_dense,
)

log = logging.getLogger("open_ludwig")


@dataclass
class SolveResult:
    total_cells: int
    steps: int
    wall_time: float
    mlups: float
    final_stats: object
    final_forces: Optional[object]


def solve_case(cfg: CaseConfig) -> SolveResult:
    from .jax_setup import setup_jax_cache

    setup_jax_cache()
    t_start = time.time()
    log.info("=" * 70)
    log.info("  LBM | D3Q27 | WALE LES | case: %s", os.path.basename(cfg.case_dir))
    log.info("=" * 70)

    dense = cfg.layout == "patch"
    if dense:
        from .core.patch import build_patches
        from .domain.builder import setup_case as _setup_blocks
        from .geometry import load_mesh
        from .scaling import compute_domain_params

        mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
        params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
        # pad every level's x-extent to the mesh size so multi-device runs
        # get even slabs
        levels = build_patches(cfg, mesh, params, x_multiple=max(cfg.devices, 1))
        statics = build_patch_statics(cfg, levels)
        states = [init_patch_state(p, cfg.precision) for p in levels]
        total_cells = sum(p.n_cells for p in levels)
        from .solver_dense import hbm_report_patches

        log.info(hbm_report_patches(levels, statics, cfg.precision))
    else:
        from .ops.storage import STORE_F32, normalize_precision

        if normalize_precision(cfg.precision) != STORE_F32:
            log.warning(
                "[Config] precision=%s is only supported on layout=patch; "
                "the blocks layout runs float32", cfg.precision,
            )
        mesh, params, levels = setup_case(cfg)
        states, statics = build_all(cfg, params, levels)
        log.info(hbm_report(levels, statics))
        total_cells = sum(g.n_cells for g in levels)
    log.info(
        "[Info] Re = %.0f, levels = %d, tau = %s",
        params.re_number,
        params.num_levels,
        ", ".join(f"{t:.6f}" for t in params.tau_levels),
    )
    log.info("[Info] total cells: %.2f M (layout=%s)", total_cells / 1e6, cfg.layout)

    out_dir = cfg.output_path
    resume_step = 0
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if cfg.checkpoint_resume and ckpt.latest_checkpoint(ckpt_dir):
        path = ckpt.latest_checkpoint(ckpt_dir)
        resume_step, states = ckpt.load_checkpoint(
            path, precision=cfg.precision if dense else None
        )
        log.info("[Checkpoint] resumed from %s at step %d", path, resume_step)
    else:
        if os.path.isdir(out_dir):
            for f in os.listdir(out_dir):
                p = os.path.join(out_dir, f)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        os.makedirs(out_dir, exist_ok=True)

    conv_csv = os.path.join(out_dir, "convergence.csv")
    force_csv = os.path.join(out_dir, "forces.csv")
    if resume_step == 0:
        write_convergence_header(conv_csv)
        if cfg.forces_enabled:
            write_forces_header(force_csv)
    else:
        # drop rows past the resume step so a re-run after a late crash
        # doesn't duplicate Step entries in the histories
        _truncate_csv_after_step(conv_csv, resume_step)
        _truncate_csv_after_step(force_csv, resume_step)

    if cfg.forces_enabled:
        force_ctx = (
            make_force_context_dense(
                mesh, levels[-1], params, extrapolate=cfg.force_extrapolate
            )
            if dense
            else make_force_context(
                mesh, levels[-1], params, extrapolate=cfg.force_extrapolate
            )
        )
    else:
        force_ctx = None
    mem_ctx = None
    if force_ctx is not None and cfg.force_method == "momentum_exchange":
        if dense:
            from .ops.storage import STORE_BF16, normalize_precision

            mem_ctx = make_mem_context(
                levels[-1], params, mesh,
                g_storage=normalize_precision(cfg.precision) == STORE_BF16,
            )
        if mem_ctx is None:
            log.warning(
                "[Forces] method=momentum_exchange needs obstacle cells on "
                "the finest level of the patch layout; falling back to "
                "stress mapping"
            )
        else:
            log.info(
                "[Forces] momentum-exchange integration over %d "
                "fluid/solid interface links", mem_ctx.n_links,
            )

    def _forces(st: List[Dict]):
        """Integrated aerodynamics at the configured method.  The stress
        mapping always runs (its per-triangle pressure/shear maps feed the
        surface VTK); momentum exchange replaces the integrals/coefficients
        (reference: the dead method at src/forces/global.jl:15-148 — live
        here because the CV study proved stress sampling cannot resolve
        streamlined-body drag, see VALIDATION.md)."""
        base = compute_aerodynamics(st[-1], force_ctx)
        if mem_ctx is None:
            return base
        return compute_aerodynamics_mem(st[-1], mem_ctx, base=base)

    if dense and cfg.devices > 1:
        from .parallel.patch_shard import (
            make_batch_runner_sharded,
            make_x_mesh,
            shard_states,
            shard_statics,
        )

        dev_mesh = make_x_mesh(cfg.devices)
        statics = shard_statics(statics, levels, dev_mesh)
        states = shard_states(states, dev_mesh)
        run = make_batch_runner_sharded(cfg, params, levels, statics, dev_mesh)
        log.info("[Mesh] sharded over %d devices (x-slabs)", dev_mesh.size)
    elif dense:
        run = make_batch_runner_dense(cfg, params, levels, statics)
    else:
        run = make_batch_runner(cfg, params, statics)

    log.info("[Run] steps=%d ramp=%d diag=%d vtk=%d",
             cfg.steps, cfg.ramp_steps, cfg.diag_freq, cfg.output_freq)
    log.info(
        "%8s | %12s | %10s | %7s | %7s | %7s | %8s | %8s",
        "Step", "Walltime", "Time[s]", "U_lat", "rho_min", "MLUPS-ref", "Cd",
        "Cl",
    )

    # event boundaries: diagnostics, VTK, forces, checkpoint
    fof = cfg.effective_force_output_freq if cfg.forces_enabled else 0
    freqs = [cfg.diag_freq, cfg.output_freq]
    if fof > 0:
        freqs.append(fof)
    if cfg.checkpoint_freq > 0:
        freqs.append(cfg.checkpoint_freq)

    profile_dir = os.environ.get("OPEN_LUDWIG_PROFILE")
    profiled = False

    t = resume_step + 1
    last_diag_time = time.time()
    last_forces = None
    final_stats = None
    while t <= cfg.steps:
        # one jax.profiler trace of the second batch (post-compile), the
        # analogue of the reference's wall-clock instrumentation (main.jl:37-42)
        if profile_dir and not profiled and t > cfg.diag_freq:
            jax.profiler.start_trace(profile_dir)
            profiled = True
        next_events = [((t - 1) // f + 1) * f for f in freqs]
        batch_end = min(min(next_events), cfg.steps)
        n = batch_end - t + 1
        # async_depth (reference: gpu.async_depth, main.jl:166-180) bounds the
        # coarse steps per dispatch; dispatches stay async (no host sync until
        # the event boundary below), so this only caps host-check granularity
        depth = cfg.async_depth if cfg.async_depth > 0 else n
        t_sub = t
        while t_sub <= batch_end:
            n_sub = min(depth, batch_end - t_sub + 1)
            states = run(states, np.int32(t_sub), int(n_sub))
            t_sub += n_sub
        t_done = batch_end

        # force-CSV cadence independent of diagnostics (reference:
        # FORCE_OUTPUT_FREQ falling back to DIAG_FREQ, config_loader.jl:192)
        if force_ctx is not None and fof > 0 and t_done % fof == 0:
            fr = _forces(states)
            last_forces = fr
            append_forces(
                force_csv, t_done, t_done * params.time_scale, fr,
                _ramp_host(t_done, cfg),
            )

        if t_done % cfg.diag_freq == 0 or t_done == cfg.steps:
            jax.block_until_ready(states[0]["rho"])
            now = time.time()
            # MLUPS-ref: cells x coarse-steps (reference: main.jl:188-190);
            # see the end-of-run summary for the convention note
            mlups = total_cells * cfg.diag_freq / max(now - last_diag_time, 1e-9) / 1e6
            last_diag_time = now
            obs0 = statics[0]["obstacle"]
            stats = compute_flow_stats(states[0], obs0.reshape(states[0]["rho"].shape))
            final_stats = stats
            t_phys = t_done * params.time_scale
            u_curr = _ramp_host(t_done, cfg)
            cd_str = cl_str = "N/A"
            if force_ctx is not None:
                # display-only here: forces.csv rows are appended exclusively
                # on force_output_freq boundaries above, matching the
                # reference's single FORCE_OUTPUT_FREQ cadence
                # (reference: forces/io.jl:100, config_loader.jl:192)
                if last_forces is None or t_done % fof != 0:
                    last_forces = _forces(states)
                fr = last_forces
                cd_str, cl_str = f"{fr.Cd:.4f}", f"{fr.Cl:.4f}"
            wall = walltime_str(t_start)
            log.info(
                "%8d | %12s | %10.4f | %.4f | %.4f | %7.1f | %8s | %8s",
                t_done, wall, t_phys, u_curr, stats.rho_min, mlups, cd_str, cl_str,
            )
            append_convergence(
                conv_csv, t_done, wall, t_phys, u_curr, stats.rho_min, mlups,
                cd_str, cl_str,
            )
            if cfg.stability_check:
                warns = check_stability(stats, t_done)
                for w in warns:
                    log.warning("[Stability] step %d: %s", t_done, w)
                diverged = not np.isfinite(stats.rho_min) or stats.rho_min < 0.5 \
                    or stats.rho_max > 1.5 or not np.isfinite(stats.v_max)
                if warns and cfg.stability_action == "abort" and diverged:
                    # checkpoint whatever state we have and end the case
                    # cleanly (the batch runner isolates per-case failures,
                    # so the remaining cases still run) instead of burning
                    # the rest of the wall-clock on a diverged field
                    path = ckpt.save_checkpoint(ckpt_dir, t_done, states)
                    log.error(
                        "[Stability] step %d: divergence detected "
                        "(stability_action=abort); state saved to %s",
                        t_done, path,
                    )
                    raise RuntimeError(
                        f"simulation diverged at step {t_done}: {warns[0]}"
                    )

        if t_done % cfg.output_freq == 0:
            if dense:
                export_flow_vtu_patches(
                    os.path.join(out_dir, f"flow_{t_done:06d}.vtu"),
                    levels, states, cfg.output_fields,
                )
            else:
                export_flow_vtu(
                    os.path.join(out_dir, f"flow_{t_done:06d}.vtu"),
                    levels, states, cfg.output_fields,
                )
            if force_ctx is not None:
                if last_forces is None or t_done % cfg.diag_freq != 0:
                    last_forces = _forces(states)
                export_surface_vtu(
                    os.path.join(out_dir, f"surface_{t_done:06d}.vtu"),
                    mesh.vertices, mesh.normals, mesh.areas,
                    last_forces.pressure_map, last_forces.shear_map,
                )

        if cfg.checkpoint_freq > 0 and t_done % cfg.checkpoint_freq == 0:
            # device fetch is synchronous (the buffers are donated to the
            # next batch right after); the zip/disk write overlaps the next
            # steps on a background thread
            ck_t0 = time.time()
            path = ckpt.save_checkpoint(ckpt_dir, t_done, states,
                                        async_write=True)
            log.info("[Checkpoint] saved %s (fetch %.1f s; write async)",
                     path, time.time() - ck_t0)

        if profiled and profile_dir:
            jax.profiler.stop_trace()
            log.info("[Profile] trace written to %s", profile_dir)
            profile_dir = None

        t = t_done + 1

    ckpt.wait_pending()  # a checkpoint write may still be in flight
    wall_total = time.time() - t_start
    # MLUPS-ref = total cells x COARSE steps / wall — the reference's
    # convention (reference: main.jl:188-190), which under-counts fine-level
    # sub-stepping.  bench.py reports MLUPS-su (true site updates,
    # cells x 2^(level-1)); on the 3-level bench case the two differ by
    # 2.86x.  Both are labeled wherever printed so neither masquerades as
    # the other.
    mlups_total = total_cells * (cfg.steps - resume_step) / max(wall_total, 1e-9) / 1e6
    log.info("=" * 70)
    log.info(
        "  COMPLETE | wall %.1f s | %.1f MLUPS-ref end-to-end "
        "(cells x coarse-steps; bench.py reports site-update MLUPS-su)",
        wall_total, mlups_total,
    )
    if last_forces is not None:
        log.info(
            "\n%s",
            print_force_summary(
                last_forces, params.rho_physical, params.u_physical,
                params.reference_area, params.reference_chord,
            ),
        )
        # time-averaged coefficients over the final third of the run — the
        # meaningful number for unsteady (vortex-shedding) flows, where the
        # instantaneous Cd printed above fluctuates by +-0.1 or more
        try:
            import csv as _csv

            rows = list(_csv.DictReader(open(force_csv)))
            cut = cfg.steps - max(cfg.steps // 3, 1)
            cds = [float(r["Cd"]) for r in rows if int(r["Step"]) >= cut]
            cls_ = [float(r["Cl"]) for r in rows if int(r["Step"]) >= cut]
            if cds:
                log.info(
                    "  time-averaged (last third): Cd = %.4f +- %.4f | "
                    "Cl = %.4f +- %.4f",
                    float(np.mean(cds)), float(np.std(cds)),
                    float(np.mean(cls_)), float(np.std(cls_)),
                )
        except Exception:
            pass
    return SolveResult(
        total_cells=total_cells,
        steps=cfg.steps,
        wall_time=wall_total,
        mlups=mlups_total,
        final_stats=final_stats,
        final_forces=last_forces,
    )


def _truncate_csv_after_step(path: str, resume_step: int) -> None:
    """Keep only the header and rows with Step <= resume_step."""
    if not os.path.isfile(path):
        return
    with open(path) as f:
        lines = f.readlines()
    if not lines:
        return
    kept = [lines[0]]
    for ln in lines[1:]:
        try:
            if int(ln.split(",", 1)[0]) <= resume_step:
                kept.append(ln)
        except ValueError:
            kept.append(ln)
    if len(kept) != len(lines):
        with open(path, "w") as f:
            f.writelines(kept)
        log.info("[Checkpoint] truncated %s to step %d (%d rows dropped)",
                 os.path.basename(path), resume_step, len(lines) - len(kept))


def _ramp_host(t: int, cfg: CaseConfig) -> float:
    if t <= cfg.ramp_steps:
        return float(cfg.u_lattice * 0.5 * (1 - np.cos(np.pi * t / cfg.ramp_steps)))
    return float(cfg.u_lattice)


def run_all_cases(cases_root: str, batch_file: str) -> None:
    """Iterate case folders with per-case error isolation
    (reference: main.jl:251-274)."""
    cases = load_batch_list(batch_file)
    log.info("MULTI-CASE EXECUTION: %d cases", len(cases))
    for i, name in enumerate(cases):
        log.info(">>> CASE %d/%d: %s", i + 1, len(cases), name)
        try:
            cfg = load_case_config(os.path.join(cases_root, name))
            solve_case(cfg)
        except Exception:
            log.exception("!!! case %s failed", name)
    log.info("ALL CASES COMPLETED")


def plan_case(cfg: CaseConfig) -> None:
    """Build the domain and print the setup/memory report without running —
    the reference's domain summary + VRAM capacity planning analogue
    (reference: physics_scaling.jl:178-187, diagnostics_vram.jl)."""
    from .core.patch import build_patches
    from .geometry import load_mesh
    from .scaling import compute_domain_params
    from .solver_dense import build_patch_statics, estimate_capacity, hbm_report_patches

    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    log.info("Case: %s | %d triangles", os.path.basename(cfg.case_dir),
             mesh.n_triangles)
    log.info("Re = %.3e | levels = %d | dx_fine = %.5g m | tau = %s",
             params.re_number, params.num_levels, params.dx_fine,
             ", ".join(f"{t:.6f}" for t in params.tau_levels))
    log.info("domain = %.2f x %.2f x %.2f m | coarse grid %dx%dx%d",
             *params.domain_size, params.nx_coarse, params.ny_coarse,
             params.nz_coarse)
    patches = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, patches)
    log.info(hbm_report_patches(patches, statics, cfg.precision))
    total = sum(p.n_cells for p in patches)
    upd = sum(p.n_cells * 2 ** (p.level_id - 1) for p in patches)
    log.info("total %.2fM cells | %.2fM site-updates per coarse step | %d steps",
             total / 1e6, upd / 1e6, cfg.steps)
    try:
        cap = estimate_capacity(precision=cfg.precision)
    except RuntimeError as e:
        log.info("capacity: not known (%s)", e)
        return
    log.info("capacity: ~%.0fM cells fit this device -> this case uses %.1f%%",
             cap / 1e6, 100.0 * sum(p.n_padded for p in patches) / cap)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m open_ludwig.runner <case_dir> [<case_dir>...]\n"
              "       python -m open_ludwig.runner --plan <case_dir>\n"
              "       python -m open_ludwig.runner --batch <cases_to_run.yaml> <cases_root>")
        return 1
    if argv[0] == "--batch":
        run_all_cases(argv[2] if len(argv) > 2 else "CASES", argv[1])
        return 0
    if argv[0] == "--plan":
        for case_dir in argv[1:]:
            plan_case(load_case_config(case_dir))
        return 0
    for case_dir in argv:
        cfg = load_case_config(case_dir)
        solve_case(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
