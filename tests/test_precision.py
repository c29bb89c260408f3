"""bf16 g-storage (ops.storage): wiring + accuracy vs the float32 path.

The stored representation is g = f - w in bfloat16 with all math in f32
(FluidX3D-style shifted storage); physics must track the f32 path closely
and the Bouzidi correction must be exactly form-invariant in g-space.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from open_ludwig import lattice as lat
from open_ludwig.cases import make_case_sphere
from open_ludwig.config import load_case_config
from open_ludwig.core.patch import build_patches
from open_ludwig.geometry import load_mesh
from open_ludwig.ops import storage
from open_ludwig.scaling import compute_domain_params
from open_ludwig.solver_dense import (
    build_patch_statics,
    init_patch_state,
    make_coarse_step_dense,
)


def test_codec_roundtrip():
    rng = np.random.default_rng(3)
    f = (lat.W[:, None, None, None] * (1 + 0.1 * rng.standard_normal(
        (27, 4, 8, 128)))).astype(np.float32)
    g = storage.encode_f(jnp.asarray(f), "bfloat16")
    assert g.dtype == jnp.bfloat16
    back = storage.decode_f(g)
    assert back.dtype == jnp.float32
    # relative error of the deviation-from-weight bounded by bf16 eps
    dev = np.abs(f - lat.W[:, None, None, None])
    err = np.abs(np.asarray(back) - f)
    assert np.all(err <= 0.01 * dev + 1e-7)
    # float32 passes through untouched
    assert storage.encode_f(jnp.asarray(f), "float32") is not None
    assert storage.decode_f(jnp.asarray(f)).dtype == jnp.float32
    # rest state encodes to exact zeros
    w = jnp.broadcast_to(jnp.asarray(lat.W)[:, None, None, None],
                         (27, 2, 8, 128)).astype(jnp.float32)
    assert not np.asarray(storage.encode_f(w, "bfloat16")).any()


def test_normalize_precision():
    assert storage.normalize_precision("bf16") == "bfloat16"
    assert storage.normalize_precision("Float32") == "float32"
    with pytest.raises(ValueError):
        storage.normalize_precision("fp8")


@pytest.fixture(scope="module")
def sphere_case(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("bf16case"))
    make_case_sphere(tmp, "1M", surface_resolution=8, num_levels=2, steps=8,
                     ramp_steps=4, output_freq=1000, diag_freq=1000)
    cfg = load_case_config(tmp)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, levels)
    return cfg, params, levels, statics


@pytest.mark.slow  # 165s; single-level bf16 parity stays in the fast suite
def test_bf16_matches_f32_multilevel(sphere_case):
    """8 coarse steps of the 2-level sphere (XLA path, incl. Bouzidi and
    interface interpolation): bf16 storage tracks f32 to ~1e-4."""
    cfg, params, levels, statics = sphere_case
    outs = {}
    for prec in ("float32", "bfloat16"):
        c = cfg.with_overrides(precision=prec)
        states = [init_patch_state(p, prec) for p in levels]
        step = make_coarse_step_dense(c, params, levels, statics)
        for t in range(1, 9):
            states = step(states, jnp.int32(t))
        outs[prec] = states
    assert outs["bfloat16"][0]["f"].dtype == jnp.bfloat16
    assert outs["bfloat16"][0]["rho"].dtype == jnp.float32
    for li in range(len(levels)):
        a, b = outs["float32"][li], outs["bfloat16"][li]
        assert float(jnp.max(jnp.abs(a["rho"] - b["rho"]))) < 1e-3
        assert float(jnp.max(jnp.abs(a["vel"] - b["vel"]))) < 1e-3


@pytest.mark.slow  # compile-heavy on CPU; full suite still runs it
def test_bf16_checkpoint_roundtrip(sphere_case, tmp_path):
    from open_ludwig import checkpoint as ckpt

    cfg, params, levels, statics = sphere_case
    states = [init_patch_state(p, "bfloat16") for p in levels]
    step = make_coarse_step_dense(
        cfg.with_overrides(precision="bfloat16"), params, levels, statics,
    )
    states = step(states, jnp.int32(1))
    path = ckpt.save_checkpoint(str(tmp_path), 1, states)
    step_no, loaded = ckpt.load_checkpoint(path)
    assert step_no == 1
    for st, ld in zip(states, loaded):
        assert ld["f"].dtype == jnp.bfloat16
        assert np.array_equal(
            np.asarray(st["f"]).view(np.uint16),
            np.asarray(ld["f"]).view(np.uint16),
        )
        assert np.array_equal(np.asarray(st["rho"]), np.asarray(ld["rho"]))
