"""Multi-level scheduler for the dense-patch layout.

Same statically-unrolled recursion as solver.make_coarse_step (reference:
src/solver_control.jl:21-143) operating on dense PatchLevel states
{f: (27, XS, YS, ZS), rho, vel}; the whole diagnostics interval runs as one
lax.scan with zero host syncs.

Each level's stream-collide is the step that `level_step_for` picks from the
platform; the refinement-interface ghost planes, the Bouzidi correction and
everything else are plain XLA.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List

import jax
import jax.numpy as jnp

from . import lattice as lat
from .config import CaseConfig
from .core.patch import PatchLevel
from .ops.dense_step import (
    apply_bouzidi_dense,
    build_bouzidi_dense_plan,
    build_iface_mm_plan,
    dense_stream_collide,
    extract_endpoint_slabs,
    interface_planes_pair_mm,
)
from .ops import storage
from .ops.triton_step import make_triton_level_step
from .scaling import DomainParams
from .solver import ramp_velocity

def init_patch_state(patch: PatchLevel, precision: str = "float32") -> Dict:
    sh = patch.padded
    if storage.normalize_precision(precision) == storage.STORE_BF16:
        # g = f - w is exactly zero at the rest equilibrium
        f = jnp.zeros((27,) + sh, jnp.bfloat16)
    else:
        f = jnp.broadcast_to(
            jnp.asarray(lat.W).reshape((27, 1, 1, 1)), (27,) + sh
        ).astype(jnp.float32)
    return {
        "f": f,
        "rho": jnp.ones(sh, jnp.float32),
        "vel": jnp.zeros((3,) + sh, jnp.float32),
    }


def build_patch_statics(cfg: CaseConfig, patches: List[PatchLevel]) -> List[Dict]:
    return [
        {
            "bouzidi": build_bouzidi_dense_plan(p, cfg.q_min_threshold),
            "obstacle": jnp.asarray(p.obstacle.reshape(-1)),
            "sponge": jnp.asarray(p.sponge.reshape(-1)),
            "wall_dist": jnp.asarray(p.wall_dist.reshape(-1)),
        }
        for p in patches
    ]


def _xla_level_step(cfg: CaseConfig, patch: PatchLevel, mesh=None) -> Callable:
    """The plain-XLA stream-collide of one level on stored f.  Over a device
    mesh XLA's SPMD partitioner splits it (`mesh` is not needed)."""
    precision = storage.normalize_precision(cfg.precision)

    def step(f, vel, u_inlet, t_seed, static, iface):
        f_new, rho, vel_new = dense_stream_collide(
            storage.decode_f(f), vel, u_inlet, t_seed, static, patch,
            c_wale=cfg.c_wale,
            nu_sgs_background=cfg.nu_sgs_background,
            inlet_turbulence=cfg.inlet_turbulence_intensity,
            wall_model=cfg.wall_model_enabled,
            sponge_blend=cfg.sponge_blend_distributions,
            iface=iface,
        )
        return storage.encode_f(f_new, precision), rho, vel_new

    return step


# platform -> builder of one level's stream-collide step
_LEVEL_STEPS = {"cpu": _xla_level_step, "gpu": make_triton_level_step}


def level_step_for(platform: str = None) -> Callable:
    """The stream-collide step builder for `platform` (default: the platform
    of the default device, so `jax.default_device` selects it too).  A
    platform without a step is an error."""
    if platform is None:
        dev = jax.config.jax_default_device
        platform = getattr(dev, "platform", dev) or jax.default_backend()
    try:
        return _LEVEL_STEPS[platform]
    except KeyError:
        raise RuntimeError(
            f"no stream-collide step for platform {platform!r}; "
            f"supported: {sorted(_LEVEL_STEPS)}"
        ) from None


def make_coarse_step_dense(
    cfg: CaseConfig, params: DomainParams, patches: List[PatchLevel],
    statics: List[Dict], mesh=None,
):
    """`mesh`: the 1-D x-slab device mesh of a sharded run (None on one
    device)."""
    n_levels = len(patches)
    use_temporal = cfg.temporal_interpolation
    make_step = level_step_for()
    steps = [make_step(cfg, p, mesh) for p in patches]
    bz_apply = [
        None if st["bouzidi"] is None
        else (lambda f, S, _plan=st["bouzidi"]:
              apply_bouzidi_dense(f, {**_plan, "S": S}))
        for st in statics
    ]
    mm_plans = [None] + [
        build_iface_mm_plan(patches[li], patches[li - 1])
        for li in range(1, n_levels)
    ]

    # over a mesh the interface slabs and ghost planes (a few planes each)
    # are replicated: every device then computes the interface einsums whole,
    # in the one-device shapes, and the x-slab run reproduces one device's
    # bits instead of summing partitioned contractions in another order
    replicated = (None if mesh is None else
                  jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))

    def slabs(plan, state):
        out = extract_endpoint_slabs(plan, state)
        if replicated is not None:
            out = jax.lax.with_sharding_constraint(out, replicated)
        return out

    def child_planes(lvl: int, old: Dict, new: Dict) -> Dict:
        """Ghost planes of level lvl+1 for both of its sub-steps: face ->
        (n_w, 27, A, B) for x faces, (n_w, A, 27, B) for y/z faces, with
        n_w = 2 under temporal interpolation (weights 0.0 and 0.5)."""
        child, parent = patches[lvl + 1], patches[lvl]
        # slab carry: the OLD endpoint slabs are the previous parent step's
        # NEW slabs (stashed under "_ifsl"), so the pre-step parent arrays
        # have no consumer besides the step itself
        plan = mm_plans[lvl + 1]
        new_sl = slabs(plan, new)
        old_sl = None
        if use_temporal:
            old_sl = old.get("_ifsl")
            if old_sl is None:
                old_sl = slabs(plan, old)
            new["_ifsl"] = new_sl
        planes = interface_planes_pair_mm(plan, child, parent, old_sl, new_sl,
                                          use_temporal)
        if replicated is not None:
            planes = jax.lax.with_sharding_constraint(planes, replicated)
        return planes

    def coarse_step(states: List[Dict], t, arrs: List[Dict] = None):
        """`arrs` (statics_arg_arrays) delivers the per-level device arrays
        as traced jit arguments; without it the closure statics are inlined
        into the HLO as literal constants (fine for tiny cases only)."""
        if arrs is None:
            arrs = statics_arg_arrays(statics)
        states = list(states)
        u_curr = ramp_velocity(t, cfg.u_lattice, cfg.ramp_steps)

        def visit(lvl: int, t_sub, iface):
            static = {**statics[lvl], **arrs[lvl]}
            st = states[lvl]
            seed = (t_sub % 1000000).astype(jnp.int32)
            f_new, rho_new, vel_new = steps[lvl](
                st["f"], st["vel"], u_curr, seed, static, iface
            )
            if bz_apply[lvl] is not None:
                f_new = bz_apply[lvl](f_new, arrs[lvl]["bz_S"])
            states[lvl] = {"f": f_new, "rho": rho_new, "vel": vel_new}
            if lvl + 1 < n_levels:
                planes = child_planes(lvl, st, states[lvl])
                for j in range(2):
                    sub = {fc: pl[min(j, pl.shape[0] - 1)]
                           for fc, pl in planes.items()}
                    visit(lvl + 1, 2 * t_sub + j, sub)

        visit(0, t, None)
        return states

    def seed_slabs(states: List[Dict]) -> List[Dict]:
        """Stash "_ifsl" (carried endpoint slabs) on every parent level so
        coarse_step's carry structure is scan-invariant.  Callers that
        lax.scan over coarse_step run this once on the initial states;
        idempotent."""
        states = list(states)
        if not use_temporal:
            return states
        for lvl in range(n_levels - 1):
            if "_ifsl" not in states[lvl]:
                states[lvl] = dict(states[lvl])
                states[lvl]["_ifsl"] = slabs(mm_plans[lvl + 1], states[lvl])
        return states

    coarse_step.seed_slabs = seed_slabs
    return coarse_step


def statics_arg_arrays(statics: List[Dict]) -> List[Dict]:
    """The per-level device arrays of `statics`, shaped as a jit-argument
    pytree.  Passing them as arguments (instead of letting the jit capture
    them by closure) keeps them out of the HLO as parameters — closure
    capture inlines every array as a literal constant, which makes compile
    payloads and compile times grow with the case size."""
    out = []
    for st in statics:
        d = {k: st[k] for k in ("obstacle", "sponge", "wall_dist")}
        if st["bouzidi"] is not None:
            d["bz_S"] = st["bouzidi"]["S"]
        out.append(d)
    return out


def make_batch_runner_dense(
    cfg: CaseConfig, params: DomainParams, patches: List[PatchLevel],
    statics: List[Dict],
):
    coarse_step = make_coarse_step_dense(cfg, params, patches, statics)
    arrs = statics_arg_arrays(statics)

    @partial(jax.jit, static_argnums=(3,), donate_argnums=(0,))
    def _run(states, arrs_, t0, n: int):
        def body(carry, t):
            return coarse_step(carry, t, arrs_), None

        out, _ = jax.lax.scan(body, states, t0 + jnp.arange(n, dtype=jnp.int32))
        return out

    def run(states, t0, n: int):
        # seed the carried endpoint slabs once so _run always sees one carry
        # structure — a single compile instead of one per seeding state
        return _run(coarse_step.seed_slabs(states), arrs, t0, n)

    run.jitted = _run
    run.arrs = arrs
    run.seed = coarse_step.seed_slabs
    return run


def hbm_bytes_per_cell(precision: str, transient: bool = True) -> float:
    """THE bytes-per-padded-cell formula, shared by hbm_report_patches and
    estimate_capacity so the planner and the report cannot disagree
    (reference's analogue: src/diagnostics_vram.jl:17-133): 27 f-entries +
    rho + vel + the static fields (obstacle u8 + sponge f32 + wall f32),
    plus the GPU step's transients: the kernel writes a new f, rho and vel
    beside the old ones (the scan's A-B pair) and reads an int8 copy of the
    obstacle mask.  chip_smoke.py checks it against the compiled step's
    memory analysis on the card."""
    f_bytes = 2 if storage.normalize_precision(precision) == storage.STORE_BF16 else 4
    per = (27 * f_bytes + 4 * (1 + 3)) + (1 + 4 + 4)
    if transient:
        per += 27 * f_bytes + 4 * (1 + 3) + 1
    return per


def hbm_report_patches(
    patches: List[PatchLevel], statics: List[Dict], precision: str = "float32"
) -> str:
    """Per-level device-memory accounting for the dense layout — the
    reference's VRAM breakdown analogue (reference:
    src/diagnostics_vram.jl:17-133).  Estimates are dtype-aware (bf16
    g-storage halves f) and cross-checked against the device's live memory
    counters, like the reference's CUDA.memory_info() comparison."""
    f_bytes = 2 if storage.normalize_precision(precision) == storage.STORE_BF16 else 4
    lines = [f"device memory (dense patches, {precision} f-storage):"]
    total = 0
    for p, st in zip(patches, statics):
        n = p.n_padded
        state_b = n * (27 * f_bytes + 4 * (1 + 3))  # f + rho + vel
        field_b = n * (1 + 4 + 4)
        assert state_b + field_b == n * hbm_bytes_per_cell(
            precision, transient=False
        )
        bz = st.get("bouzidi")
        bz_b = int(bz["S"].size) * bz["S"].dtype.itemsize if bz else 0
        total += state_b + field_b + bz_b
        lines.append(
            f"  level {p.level_id}: {p.n_cells/1e6:7.2f}M cells "
            f"({n/1e6:.2f}M padded) | state {state_b/1e6:8.1f} MB | fields "
            f"{field_b/1e6:6.1f} MB | bouzidi {bz_b/1e6:5.1f} MB"
        )
    # the step's transient: the largest level dominates
    trans = max(p.n_padded for p in patches) * (
        hbm_bytes_per_cell(precision) - hbm_bytes_per_cell(precision, False)
    )
    total += trans
    lines.append(
        f"  estimated total: {total/1e9:.3f} GB "
        f"(incl. {trans/1e6:.0f} MB step transients)"
    )
    ms = jax.local_devices()[0].memory_stats()
    if ms and "bytes_in_use" in ms:
        live = ms["bytes_in_use"]
        limit = ms.get("bytes_limit", 0)
        lines.append(
            f"  device live: {live/1e9:.3f} GB in use"
            + (f" of {limit/1e9:.1f} GB" if limit else "")
            + f" (estimate/live = {total/max(live,1):.2f})"
        )
    return "\n".join(lines)


def estimate_capacity(hbm_gb: float = 0.0, precision: str = "float32") -> int:
    """Cells that fit in the given device memory (0 = read the device's
    `bytes_limit`), the reference's mesh-capacity planner analogue
    (reference: src/diagnostics_vram.jl estimate_mesh_capacity)."""
    if hbm_gb <= 0.0:
        ms = jax.local_devices()[0].memory_stats() or {}
        if "bytes_limit" not in ms:
            raise RuntimeError(
                "device reports no memory limit; pass hbm_gb explicitly"
            )
        hbm_gb = ms["bytes_limit"] / 1e9
    return int(hbm_gb * 1e9 / hbm_bytes_per_cell(precision, transient=True))
