"""The Triton stream-collide kernel (ops.triton_step) against the XLA step
(ops.dense_step via solver_dense._xla_level_step): in the Pallas
interpreter on the CPU, and compiled on a card where there is one."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from open_ludwig import lattice as lat
from open_ludwig.config import CaseConfig
from open_ludwig.core.patch import (
    BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel,
)
from open_ludwig.ops import storage
from open_ludwig.ops.triton_step import make_triton_level_step
from open_ludwig.solver_dense import _xla_level_step

I = BC_INTERFACE
DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)


def _case(rng, interior, face_bc, precision, x_pad=0, wall_model=True):
    X, Y, Z = interior
    padded = (X + x_pad, Y, Z)
    obstacle = np.ones(padded, bool)
    obstacle[:X] = False
    obstacle[X // 3:X // 3 + 2, Y // 3:Y // 3 + 2, Z // 3:Z // 3 + 2] = True
    sponge = np.zeros(padded, np.float32)
    sponge[X - 2:X] = 0.3
    wall = np.full(padded, 100.0, np.float32)
    near = rng.random(padded) < 0.1
    wall[near] = rng.uniform(0.6, 4.0, near.sum())
    patch = PatchLevel(2, 0.5, 0.53, (4, 6, 2), interior, padded,
                       tuple(face_bc), obstacle, sponge, wall)
    cfg = CaseConfig(precision=precision, c_wale=0.5, nu_sgs_background=5e-4,
                     inlet_turbulence_intensity=0.05,
                     wall_model_enabled=wall_model,
                     sponge_blend_distributions=True)
    static = {"obstacle": jnp.asarray(obstacle.reshape(-1)),
              "sponge": jnp.asarray(sponge.reshape(-1)),
              "wall_dist": jnp.asarray(wall.reshape(-1))}
    f = lat.W[:, None, None, None] * (
        1.0 + 0.05 * rng.standard_normal((27,) + padded))
    vel = 0.02 * rng.standard_normal((3,) + padded)
    iface = {}
    for fc in range(6):
        if face_bc[fc] != I:
            continue
        ax = fc // 2
        A, B = (padded[a] for a in range(3) if a != ax)
        pl = lat.W[:, None, None] * (1.0 + 0.05 * rng.standard_normal((27, A, B)))
        # x faces (27, YS, ZS); y and z faces x-rows first (XS, 27, B)
        iface[fc] = jnp.asarray(pl if ax == 0 else pl.transpose(1, 0, 2),
                                jnp.float32)
    args = (storage.encode_f(jnp.asarray(f, jnp.float32), precision),
            jnp.asarray(vel, jnp.float32), jnp.float32(0.04), jnp.int32(7),
            static, iface)
    return cfg, patch, args


def _max_errors(patch, a, b):
    X, Y, Z = patch.interior
    return [float(np.abs(np.asarray(x, np.float32)[..., :X, :Y, :Z]
                         - np.asarray(y, np.float32)[..., :X, :Y, :Z]).max())
            for x, y in zip(a, b)]


# (precision, interior, faces, x pad).  Bounds: float32 arithmetic in
# another order (the kernel's factorized collision against the XLA step's
# (27, N) sums); under bf16 g-storage such a last-bit difference can round
# a stored g to the neighbouring bf16 number, one ulp = 2^-8 of |g| < 0.06
# here
CASES = {
    "f32_domain": ("float32", (12, 10, 9), DOMAIN, 0),
    "bf16_domain": ("bfloat16", (12, 10, 9), DOMAIN, 0),
    "f32_iface_x8": ("float32", (8, 9, 7), (I,) * 6, 0),
    "bf16_iface_x16": ("bfloat16", (16, 9, 7), (I, BC_OUTLET, I, BC_MIRROR_Y,
                                                BC_MIRROR_Z, I), 0),
    "f32_x_padded": ("float32", (10, 8, 6), (BC_INLET, I, I, I, I, I), 6),
}
TOL = {"float32": 1e-6, "bfloat16": 2.5e-4}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_xla_interpret(rng, name):
    precision, interior, faces, x_pad = CASES[name]
    cfg, patch, args = _case(rng, interior, faces, precision, x_pad)
    want = jax.jit(_xla_level_step(cfg, patch))(*args)
    got = jax.jit(make_triton_level_step(cfg, patch, block=64,
                                         interpret=True))(*args)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    errs = _max_errors(patch, got, want)
    assert max(errs) <= TOL[precision], errs


def test_kernel_block_size_does_not_change_results(rng):
    """Blocks that split rows and planes anywhere give the same bits."""
    cfg, patch, args = _case(rng, (9, 7, 5), DOMAIN, "float32",
                             wall_model=False)
    a = jax.jit(make_triton_level_step(cfg, patch, block=32, interpret=True))(*args)
    b = jax.jit(make_triton_level_step(cfg, patch, block=128, interpret=True))(*args)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_kernel_matches_xla_on_card(rng, gpu_device, precision):
    """The kernel as compiled for the card, at a shape whose cell count is
    not a multiple of the block."""
    cfg, patch, args = _case(rng, (40, 36, 30), (I, BC_OUTLET, I, BC_MIRROR_Y,
                                                 BC_MIRROR_Z, I), precision)
    args = jax.device_put(args, gpu_device)
    want = jax.jit(_xla_level_step(cfg, patch))(*args)
    got = jax.jit(make_triton_level_step(cfg, patch))(*args)
    errs = _max_errors(patch, got, want)
    assert max(errs) <= TOL[precision], errs


@pytest.mark.parametrize("name", ["f32_domain", "bf16_iface_x16"])
def test_sharded_kernel_matches_single_interpret(rng, name):
    """The kernel under shard_map over 4 x-slabs, with ppermute halo planes,
    against the XLA step on one device."""
    from open_ludwig.parallel.patch_shard import make_x_mesh

    precision, interior, faces, _ = CASES[name]
    X = interior[0]
    cfg, patch, args = _case(rng, interior, faces, precision, x_pad=-X % 4)
    want = jax.jit(_xla_level_step(cfg, patch))(*args)
    step = make_triton_level_step(cfg, patch, make_x_mesh(4), block=32,
                                  interpret=True)
    got = jax.jit(step)(*args)
    assert len(got[0].sharding.device_set) == 4
    errs = _max_errors(patch, got, want)
    assert max(errs) <= TOL[precision], errs


def test_sharded_multilevel_matches_single_interpret(tmp_path, monkeypatch):
    """The whole multi-level coarse step (kernel levels, interface planes,
    Bouzidi) over a 4-device x-slab mesh reproduces one device bit for bit:
    the interface einsums run replicated, in the one-device shapes."""
    from functools import partial

    from open_ludwig import solver_dense
    from open_ludwig.cases import make_case_sphere
    from open_ludwig.config import load_case_config
    from open_ludwig.core.patch import build_patches
    from open_ludwig.geometry import load_mesh
    from open_ludwig.parallel.patch_shard import (
        make_batch_runner_sharded, make_x_mesh, shard_states, shard_statics,
    )
    from open_ludwig.scaling import compute_domain_params

    monkeypatch.setitem(solver_dense._LEVEL_STEPS, "cpu", partial(
        make_triton_level_step, block=512, interpret=True))
    make_case_sphere(str(tmp_path), "1M", surface_resolution=8, num_levels=2,
                     steps=12, ramp_steps=2, output_freq=1000, diag_freq=1000)
    cfg = load_case_config(str(tmp_path))
    tri = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, tri.min_bounds, tri.max_bounds)
    levels = build_patches(cfg, tri, params, x_multiple=4)
    assert levels[-1].bouzidi is not None
    statics = solver_dense.build_patch_statics(cfg, levels)
    states = [solver_dense.init_patch_state(p, cfg.precision) for p in levels]
    mesh = make_x_mesh(4)
    run4 = make_batch_runner_sharded(cfg, params, levels,
                                     shard_statics(statics, levels, mesh), mesh)
    s4 = run4(shard_states(states, mesh), np.int32(1), 12)
    run1 = solver_dense.make_batch_runner_dense(cfg, params, levels, statics)
    s1 = run1([dict(s) for s in states], np.int32(1), 12)
    for a, b in zip(s4, s1):
        for key in ("f", "rho", "vel"):
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
