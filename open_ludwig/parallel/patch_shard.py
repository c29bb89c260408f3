"""Multi-device execution: x-slab sharding of the FULL dense-patch
multi-level step.

Every level's state arrays are sharded along the x (streaming) axis over a
1-D device mesh.  The level step is the one solver_dense.level_step_for
picks for the platform, given the mesh: the GPU kernel runs under
`shard_map` with `ppermute` halo planes (ops.triton_step); the XLA step
(CPU) is partitioned by XLA's SPMD partitioner, which inserts the halo
collective-permutes for its x-rolls.  Everything around the step — the
refinement-interface slabs and einsums, the Bouzidi sub-box, forces and
diagnostics — is GSPMD-partitioned XLA with the collectives the partitioner
inserts (SURVEY.md section 2.6, section 5).

The physics is the single-device path itself.  The reference has no
multi-GPU support at all (reference: src/ has a single CUDABackend,
main.jl:75).  The mesh is 1-D because the cards of one host reach each
other all to all; it follows the algorithm's one decomposed axis.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CaseConfig
from ..core.patch import PatchLevel
from ..scaling import DomainParams
from ..solver_dense import make_coarse_step_dense, statics_arg_arrays


def make_x_mesh(n_devices: int = 0) -> Mesh:
    """1-D device mesh over the streaming axis, one x-slab per distinct
    device.  n_devices = 0 uses all local devices."""
    devs = jax.devices()
    n = n_devices if n_devices > 0 else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), axis_names=("x",))


def state_shardings(mesh: Mesh) -> Dict[str, NamedSharding]:
    """Shardings for one level's {f, rho, vel} state dict: x-slabs."""
    return {
        "f": NamedSharding(mesh, P(None, "x")),      # (27, XS, YS, ZS)
        "rho": NamedSharding(mesh, P("x")),           # (XS, YS, ZS)
        "vel": NamedSharding(mesh, P(None, "x")),     # (3, XS, YS, ZS)
    }


def shard_states(states: List[Dict], mesh: Mesh) -> List[Dict]:
    sh = state_shardings(mesh)
    # derived carries (e.g. "_ifsl" slabs) are dropped: the batch runner
    # re-seeds them on device with GSPMD-inferred placements
    return [
        {k: jax.device_put(v, sh[k]) for k, v in st.items() if k in sh}
        for st in states
    ]


def shard_statics(statics: List[Dict], patches: List[PatchLevel],
                  mesh: Mesh) -> List[Dict]:
    """Static fields: the flat (N,) per-cell fields are x-major, so an x-slab
    sharding of dim 0 lines up with the state slabs when XS divides evenly;
    XLA reshards transparently when it doesn't.  Small Bouzidi boxes are
    replicated."""
    rep = NamedSharding(mesh, P())
    flat = NamedSharding(mesh, P("x"))
    out = []
    for st, p in zip(statics, patches):
        d = {}
        for k, v in st.items():
            if k == "bouzidi":
                d[k] = (
                    None if v is None
                    else {kk: (jax.device_put(vv, rep) if hasattr(vv, "shape") else vv)
                          for kk, vv in v.items()}
                )
            elif k in ("obstacle", "sponge", "wall_dist") and p.padded[0] % mesh.size == 0:
                d[k] = jax.device_put(v, flat)
            else:
                d[k] = jax.device_put(v, rep)
        out.append(d)
    return out


def make_batch_runner_sharded(
    cfg: CaseConfig,
    params: DomainParams,
    patches: List[PatchLevel],
    statics: List[Dict],
    mesh: Mesh,
):
    """Sharded analogue of solver_dense.make_batch_runner_dense: the whole
    diagnostics interval is one jitted lax.scan over the sharded states."""
    coarse_step = make_coarse_step_dense(cfg, params, patches, statics, mesh)
    # statics ride as traced jit arguments (statics_arg_arrays) exactly as in
    # make_batch_runner_dense; the arrays keep the shardings shard_statics
    # committed them with, and jit honors those placements.
    arrs = statics_arg_arrays(statics)

    @partial(jax.jit, static_argnums=(3,), donate_argnums=(0,))
    def _run(states, arrs_, t0, n: int):
        def body(carry, t):
            return coarse_step(list(carry), t, arrs_), None

        out, _ = jax.lax.scan(
            body, states, t0 + jax.numpy.arange(n, dtype=jax.numpy.int32)
        )
        return out

    def run(states, t0, n: int):
        # seed the carried endpoint slabs (same carry-structure contract as
        # make_batch_runner_dense); the slab arrays inherit GSPMD placements
        return _run(coarse_step.seed_slabs(states), arrs, t0, n)

    return run
