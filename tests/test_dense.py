"""Dense-patch path validation: single level vs the naive oracle, equilibrium
fixed point, and two-level interface behavior."""

import numpy as np
import pytest

import jax.numpy as jnp

from open_ludwig import lattice as lat
from open_ludwig.core.patch import (
    BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel,
)
from open_ludwig.ops.dense_step import (
    build_iface_mm_plan,
    dense_stream_collide,
    extract_endpoint_slabs,
    interface_planes_pair_mm,
)

from reference_impl import naive_step


def _patch(interior, tau=0.52, lo=(0, 0, 0), face_bc=None, obstacle=None,
           sponge=None, wall=None, dx=1.0, level_id=1):
    X, Y, Z = interior
    XS, YS, ZS = X, Y, Z
    def pad(a, fill, dtype):
        out = np.full((XS, YS, ZS), fill, dtype)
        if a is not None:
            out[:X, :Y, :Z] = a
        return out
    return PatchLevel(
        level_id=level_id,
        dx=dx,
        tau=tau,
        lo=lo,
        interior=interior,
        padded=(XS, YS, ZS),
        face_bc=tuple(face_bc or (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y,
                                  BC_MIRROR_Z, BC_MIRROR_Z)),
        obstacle=pad(obstacle, True, bool) if obstacle is not None else pad(np.zeros(interior, bool), True, bool),
        sponge=pad(sponge if sponge is not None else np.zeros(interior, np.float32), 0.0, np.float32),
        wall_dist=pad(wall if wall is not None else np.full(interior, 100.0, np.float32), 100.0, np.float32),
    )


def _statics(p):
    return {
        "obstacle": jnp.asarray(p.obstacle.reshape(-1)),
        "sponge": jnp.asarray(p.sponge.reshape(-1)),
        "wall_dist": jnp.asarray(p.wall_dist.reshape(-1)),
        "bouzidi": None,
    }


def _to_padded(a, p):
    lead = a.shape[: a.ndim - 3]
    out = np.zeros(lead + p.padded, a.dtype)
    X, Y, Z = p.interior
    out[..., :X, :Y, :Z] = a
    return jnp.asarray(out)


def _interior(a, p):
    X, Y, Z = p.interior
    return np.asarray(a)[..., :X, :Y, :Z]


@pytest.mark.parametrize(
    "wall_model,sponge_blend,inlet_turb",
    [(False, False, 0.0), (True, True, 0.05)],
)
def test_dense_matches_oracle(rng, wall_model, sponge_blend, inlet_turb):
    X, Y, Z = 12, 10, 9
    tau = 0.52
    f0 = np.asarray(lat.W64[:, None, None, None]) * (
        1.0 + 0.05 * rng.standard_normal((27, X, Y, Z))
    )
    vel0 = 0.02 * rng.standard_normal((3, X, Y, Z))
    obstacle = np.zeros((X, Y, Z), bool)
    obstacle[5:8, 4:6, 4:6] = True
    sponge = np.zeros((X, Y, Z), np.float32)
    sponge[9:, :, :] = np.linspace(0.1, 0.8, 3)[:, None, None]
    wall = np.full((X, Y, Z), 100.0, np.float32)
    wall[4, 5, 5] = 1.2

    kw = dict(u_inlet=0.05, t_seed=7, tau=tau, c_wale=0.5, nu_sgs=5e-4,
              inlet_turb=inlet_turb, wall_model=wall_model,
              sponge_blend=sponge_blend)
    f_ref = f0.astype(np.float32).astype(np.float64)
    v_ref = vel0.astype(np.float32).astype(np.float64)
    f_ref, rho_ref, v_ref = naive_step(f_ref, v_ref, obstacle, sponge, wall, **kw)
    f_ref2, rho_ref2, v_ref2 = naive_step(f_ref, v_ref, obstacle, sponge, wall, **kw)

    p = _patch((X, Y, Z), tau=tau, obstacle=obstacle, sponge=sponge, wall=wall)
    st = _statics(p)
    fj = _to_padded(f0.astype(np.float32), p)
    vj = _to_padded(vel0.astype(np.float32), p)
    op = dict(c_wale=0.5, nu_sgs_background=5e-4, inlet_turbulence=inlet_turb,
              wall_model=wall_model, sponge_blend=sponge_blend)
    f1, r1, v1 = dense_stream_collide(fj, vj, jnp.float32(0.05), jnp.int32(7), st, p, **op)
    f2, r2, v2 = dense_stream_collide(f1, v1, jnp.float32(0.05), jnp.int32(7), st, p, **op)

    assert np.allclose(_interior(f2, p), f_ref2, atol=2e-5), \
        np.abs(_interior(f2, p) - f_ref2).max()
    assert np.allclose(_interior(r2, p), rho_ref2, atol=2e-5)
    assert np.allclose(_interior(v2, p), v_ref2, atol=2e-5)


def test_dense_equilibrium_fixed_point():
    p = _patch((8, 8, 8), tau=0.6)
    st = _statics(p)
    f = jnp.broadcast_to(jnp.asarray(lat.W)[:, None, None, None],
                         (27,) + p.padded).astype(jnp.float32)
    v = jnp.zeros((3,) + p.padded, jnp.float32)
    f1, r1, v1 = dense_stream_collide(
        f, v, jnp.float32(0.0), jnp.int32(0), st, p,
        c_wale=0.5, nu_sgs_background=0.0, inlet_turbulence=0.0,
        wall_model=False, sponge_blend=True)
    assert np.allclose(_interior(f1, p), np.asarray(lat.W)[:, None, None, None],
                       atol=1e-7)
    assert np.allclose(_interior(r1, p), 1.0, atol=1e-6)


def _ghost_planes(child, parent, old, new, use_temporal):
    """The scheduler's ghost planes, x faces (n_w, 27, A, B) and y/z faces
    brought to the same (n_w, 27, A, B) layout."""
    plan = build_iface_mm_plan(child, parent)
    planes = interface_planes_pair_mm(
        plan, child, parent, extract_endpoint_slabs(plan, old),
        extract_endpoint_slabs(plan, new), use_temporal)
    return {fc: np.asarray(pl if fc < 2 else jnp.swapaxes(pl, 1, 2))
            for fc, pl in planes.items()}


def test_interface_plane_uniform_parent():
    """A uniform-equilibrium parent must produce exactly W_k ghost planes on
    every interface face (trilinear interp of constants + zero f_neq)."""
    parent = _patch((16, 16, 16), tau=0.58, level_id=1)
    child = _patch((12, 12, 12), tau=0.54, lo=(10, 10, 10),
                   face_bc=[BC_INTERFACE] * 6, level_id=2, dx=0.5)
    pstate = {
        "f": jnp.broadcast_to(jnp.asarray(lat.W)[:, None, None, None],
                              (27,) + parent.padded).astype(jnp.float32),
        "rho": jnp.ones(parent.padded, jnp.float32),
        "vel": jnp.zeros((3,) + parent.padded, jnp.float32),
    }
    planes = _ghost_planes(child, parent, pstate, pstate, True)
    assert sorted(planes) == list(range(6))
    want = np.asarray(lat.W)[None, :, None, None]
    for face, pl in planes.items():
        assert pl.shape[:2] == (2, 27), (face, pl.shape)
        assert np.allclose(pl, want, atol=1e-6), face


def test_interface_plane_linear_field():
    """Parent rho varying linearly in x: the parity-biased trilinear rule must
    reproduce the reference's corner/weight choice (g//2-1, g//2 with weight
    0.25/0.75 by parity)."""
    parent = _patch((16, 16, 16), tau=0.58)
    child = _patch((8, 8, 8), tau=0.54, lo=(12, 12, 12),
                   face_bc=[BC_INTERFACE] * 6, level_id=2, dx=0.5)
    rho_np = np.ones(parent.padded, np.float32)
    for i in range(16):
        rho_np[i, :, :] = 1.0 + 0.01 * i
    pstate = {
        "f": jnp.broadcast_to(jnp.asarray(lat.W)[:, None, None, None],
                              (27,) + parent.padded).astype(jnp.float32)
        * jnp.asarray(rho_np)[None],
        "rho": jnp.asarray(rho_np),
        "vel": jnp.zeros((3,) + parent.padded, jnp.float32),
    }
    # x-min face: fine ghost layer at fine g = 11 -> parent corners (4, 5),
    # weight 0.75 (odd)
    pl = _ghost_planes(child, parent, pstate, pstate, False)[0]
    rho_expect = (1.0 + 0.01 * 4) * 0.25 + (1.0 + 0.01 * 5) * 0.75
    # rest-direction k=13: value = W13 * rho (f = W*rho is equilibrium at u=0)
    assert pl[0, 13, 1, 1] == pytest.approx(lat.W64[13] * rho_expect, rel=1e-5)


@pytest.mark.slow  # compile-heavy on CPU; full suite still runs it
@pytest.mark.parametrize("use_temporal", [True, False])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("parent_lo", [(0, 0, 0), (6, 4, 2)])
def test_interface_planes_pair_mm_parity(rng, use_temporal, precision,
                                         parent_lo):
    """The einsum-operator interface pipeline (interface_planes_pair_mm) must
    match the float64 oracle of the ghost planes on random states.

    parent_lo != 0 covers deep levels (level 3+), whose parent array is
    itself offset in global coordinates — a regression once (global vs
    parent-local slab coordinates) that doubled the validated sphere Cd."""
    from open_ludwig.ops import storage

    from reference_impl import naive_iface_plane

    parent = _patch((20, 16, 16), tau=0.58, level_id=1, lo=parent_lo)
    child = _patch((14, 12, 12), tau=0.54,
                   lo=(2 * parent_lo[0] + 10, 2 * parent_lo[1] + 8,
                       2 * parent_lo[2] + 8),
                   face_bc=[BC_INTERFACE] * 6, level_id=2, dx=0.5)

    def rand_state():
        f = lat.W[:, None, None, None] * (
            1.0 + 0.05 * rng.standard_normal((27,) + parent.padded))
        return {
            "f": storage.encode_f(jnp.asarray(f, jnp.float32), precision),
            "rho": jnp.asarray(
                1.0 + 0.02 * rng.standard_normal(parent.padded)
            ).astype(jnp.float32),
            "vel": jnp.asarray(
                0.03 * rng.standard_normal((3,) + parent.padded)
            ).astype(jnp.float32),
        }

    def f64(st):
        return {"f": np.asarray(storage.decode_f(st["f"]), np.float64),
                "rho": np.asarray(st["rho"], np.float64),
                "vel": np.asarray(st["vel"], np.float64)}

    st_old, st_new = rand_state(), rand_state()
    got = _ghost_planes(child, parent, st_old, st_new, use_temporal)
    scale = (child.tau - 0.5) / (parent.tau - 0.5)
    weights = ([(1.0, 0.0), (0.5, 0.5)] if use_temporal else [(0.0, 1.0)])
    # bf16 einsum operands round the normal-lerp weights (<0.4%)
    tol = 2e-6 if precision == "float32" else 2e-3
    for face, pl in got.items():
        for j, w in enumerate(weights):
            want = naive_iface_plane(face, child.lo, child.interior,
                                     child.padded, parent.lo,
                                     [f64(st_old), f64(st_new)], w, scale)
            err = np.abs(pl[j] - want).max()
            assert err <= tol, (face, j, err)


def test_hbm_accounting_shared_formula():
    """estimate_capacity and hbm_report_patches must share one
    bytes-per-cell formula (they disagreed by ~15% once: the report counted
    the static fields, the planner did not count the step's transients).
    The planner's capacity, re-expanded through the per-cell formula, must
    land within rounding of the budget it planned."""
    from open_ludwig.solver_dense import estimate_capacity, hbm_bytes_per_cell

    for precision in ("float32", "bfloat16"):
        per = hbm_bytes_per_cell(precision, transient=True)
        resident = hbm_bytes_per_cell(precision, transient=False)
        f_bytes = 2 if precision == "bfloat16" else 4
        # resident: f + rho + vel + obstacle/sponge/wall
        assert resident == 27 * f_bytes + 16 + 9
        # the GPU step's transients: a second f, rho and vel, plus the int8
        # obstacle mask the kernel reads
        assert per - resident == 27 * f_bytes + 16 + 1
        cap = estimate_capacity(hbm_gb=16.0, precision=precision)
        assert abs(cap * per - 16.0e9) < per  # exact inverse of the formula


@pytest.mark.parametrize("precision,tol", [("float32", 2e-5), ("bfloat16", 2e-3)])
def test_two_level_coarse_step_matches_oracle(rng, precision, tol):
    """One coarse step of the multi-level scheduler (a parent step, then two
    child sub-steps whose ghost planes are interpolated in space and time
    from the parent) against the float64 oracle.  The interface einsums run
    at the pinned precision (HIGHEST for float32 operands), so the float32
    bound is the single-level one; bf16 g-storage rounds every stored f to
    one bf16 ulp of g (~1e-4 of f), hence its looser bound."""
    from open_ludwig.config import CaseConfig
    from open_ludwig.ops import storage
    from open_ludwig.solver_dense import build_patch_statics, make_coarse_step_dense

    from reference_impl import naive_iface_plane

    wall_p = np.full((20, 16, 16), 100.0, np.float32)
    wall_p[rng.random(wall_p.shape) < 0.05] = 2.0
    parent = _patch((20, 16, 16), tau=0.56, wall=wall_p)
    child = _patch((14, 12, 12), tau=0.52, lo=(10, 8, 8), level_id=2, dx=0.5,
                   face_bc=[BC_INTERFACE] * 6)
    cfg = CaseConfig(u_lattice=0.04, ramp_steps=1, c_wale=0.5,
                     nu_sgs_background=5e-4, inlet_turbulence_intensity=0.05,
                     wall_model_enabled=True, sponge_blend_distributions=True,
                     temporal_interpolation=True, precision=precision)
    patches = [parent, child]

    def rand_state(p):
        f = lat.W64[:, None, None, None] * (
            1.0 + 0.03 * rng.standard_normal((27,) + p.padded))
        return {
            "f": storage.encode_f(jnp.asarray(f, jnp.float32), precision),
            "rho": jnp.asarray(1.0 + 0.01 * rng.standard_normal(p.padded),
                               jnp.float32),
            "vel": jnp.asarray(0.02 * rng.standard_normal((3,) + p.padded),
                               jnp.float32),
        }

    states = [rand_state(p) for p in patches]
    t = 5
    step = make_coarse_step_dense(cfg, None, patches,
                                  build_patch_statics(cfg, patches))
    got = step(states, jnp.int32(t))

    def f64(st):
        return {"f": np.asarray(storage.decode_f(st["f"]), np.float64),
                "rho": np.asarray(st["rho"], np.float64),
                "vel": np.asarray(st["vel"], np.float64)}

    kw = dict(u_inlet=np.float64(np.float32(0.04)), c_wale=0.5, nu_sgs=5e-4,
              inlet_turb=0.05, wall_model=True, sponge_blend=True)
    old = f64(states[0])
    f, r, v = naive_step(old["f"], old["vel"], parent.obstacle, parent.sponge,
                         parent.wall_dist.astype(np.float64), t_seed=t,
                         tau=parent.tau, **kw)
    new = {"f": f, "rho": r, "vel": v}
    want = [new]
    scale = (child.tau - 0.5) / (parent.tau - 0.5)
    ch = f64(states[1])
    for j, wts in enumerate(((1.0, 0.0), (0.5, 0.5))):
        iface = {fc: naive_iface_plane(fc, child.lo, child.interior,
                                       child.padded, parent.lo, [old, new],
                                       wts, scale)
                 for fc in range(6)}
        f, r, v = naive_step(ch["f"], ch["vel"], child.obstacle, child.sponge,
                             child.wall_dist.astype(np.float64),
                             t_seed=2 * t + j, tau=child.tau,
                             face_bc=child.face_bc, iface=iface, lo=child.lo,
                             **kw)
        ch = {"f": f, "rho": r, "vel": v}
    want.append(ch)
    for lvl, (g, w) in enumerate(zip(got, want)):
        for key in ("f", "rho", "vel"):
            a = np.asarray(storage.decode_f(g[key]) if key == "f" else g[key])
            err = np.abs(a - w[key]).max()
            assert err <= tol, (lvl, key, err)
