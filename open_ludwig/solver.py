"""Multi-level time stepping: the reference's recursive schedule, unrolled
statically and compiled into one lax.scan.

The reference recursion (reference: src/solver_control.jl:21-143) visits level
l 2^(l-1) times per coarse step with temporal weights 0.0 / 0.5 on the two
sub-steps, synchronizing the device after EVERY level-step — the main perf
bottleneck identified in SURVEY.md section 3.3.  Here the whole recursion is a
static Python unroll inside the scan body: zero host round-trips between
diagnostics intervals, and XLA overlaps/fuses across level-steps.

Functional buffer handling replaces the reference's A-B parity swap: each
sub-step consumes {f, rho, vel} and produces new ones, the "old" coarse state
needed by fine-level temporal interpolation is just the pre-step binding (its
lifetime is one coarse step, so it never enters the scan carry).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import CaseConfig
from .ops.stream_collide import apply_bouzidi, stream_collide
from .scaling import DomainParams


def ramp_velocity(t, u_target: float, ramp_steps: int):
    """Cosine start-up ramp (reference: main.jl:173-174), evaluated per step."""
    t_f = t.astype(jnp.float32)
    prog = jnp.where(
        t_f <= ramp_steps,
        0.5 * (1.0 - jnp.cos(jnp.pi * t_f / float(max(ramp_steps, 1)))),
        1.0,
    )
    return jnp.float32(u_target) * prog


def _parent_view(state: Dict, old: Dict) -> Dict:
    return {
        "f": state["f"].reshape(27, -1),
        "rho": state["rho"].reshape(-1),
        "vel": state["vel"].reshape(3, -1),
        "f_old": old["f"].reshape(27, -1),
        "rho_old": old["rho"].reshape(-1),
        "vel_old": old["vel"].reshape(3, -1),
    }


def make_coarse_step(cfg: CaseConfig, params: DomainParams, statics: List[Dict]):
    """Returns coarse_step(states, t) -> states advancing ALL levels by one
    coarse step (level l advances 2^(l-1) sub-steps)."""
    n_levels = len(statics)
    use_temporal = cfg.temporal_interpolation

    def coarse_step(states: List[Dict], t):
        states = list(states)
        u_curr = ramp_velocity(t, cfg.u_lattice, cfg.ramp_steps)

        def step_level(lvl: int, t_sub, temporal_weight: float, parent_view):
            st = states[lvl]
            static = statics[lvl]
            f_new, rho_new, vel_new = stream_collide(
                st["f"],
                st["vel"],
                u_curr,
                (t_sub % 1000000).astype(jnp.int32),
                static,
                tau=float(params.tau_levels[lvl]),
                c_wale=cfg.c_wale,
                nu_sgs_background=cfg.nu_sgs_background,
                inlet_turbulence=cfg.inlet_turbulence_intensity,
                wall_model=cfg.wall_model_enabled,
                sponge_blend=cfg.sponge_blend_distributions,
                use_temporal=use_temporal,
                temporal_weight=temporal_weight,
                parent=parent_view,
            )
            if static["bouzidi"] is not None:
                f_new = apply_bouzidi(f_new, static["bouzidi"])
            states[lvl] = {"f": f_new, "rho": rho_new, "vel": vel_new}

        def visit(lvl: int, t_sub, temporal_weight: float, parent_view):
            has_children = lvl + 1 < n_levels
            old = states[lvl] if (has_children and use_temporal) else None
            step_level(lvl, t_sub, temporal_weight, parent_view)
            if has_children:
                pv = _parent_view(states[lvl], old if old is not None else states[lvl])
                visit(lvl + 1, 2 * t_sub, 0.0, pv)
                visit(lvl + 1, 2 * t_sub + 1, 0.5, pv)

        visit(0, t, 0.0, None)
        return states

    return coarse_step


def make_batch_runner(cfg: CaseConfig, params: DomainParams, statics: List[Dict]):
    """Returns run(states, t0, n) jitted over static n: advances n coarse steps
    with a lax.scan (the whole diagnostics interval on device — the
    analogue of the reference's gpu.async_depth batching, reference:
    main.jl:166-180)."""
    coarse_step = make_coarse_step(cfg, params, statics)

    @partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
    def run(states, t0, n: int):
        def body(carry, t):
            return coarse_step(carry, t), None

        out, _ = jax.lax.scan(body, states, t0 + jnp.arange(n, dtype=jnp.int32))
        return out

    return run
