"""Dense-patch builder invariants, dense-vs-sparse Bouzidi equivalence, and
the sharded dense step on a virtual device mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from open_ludwig.config import CaseConfig
from open_ludwig.core.patch import (
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
    build_patches,
)
from open_ludwig.domain.bouzidi import BouzidiData
from open_ludwig.geometry import load_mesh, make_icosphere, save_binary_stl
from open_ludwig.ops.dense_step import (
    apply_bouzidi_dense,
    build_bouzidi_dense_plan,
    build_bouzidi_patch_plan,
)
from open_ludwig.ops.stream_collide import apply_bouzidi
from open_ludwig.scaling import compute_domain_params


def _patch(interior, tau=0.52, lo=(0, 0, 0), face_bc=None, level_id=1):
    X, Y, Z = interior
    XS, YS, ZS = X, Y, Z
    return PatchLevel(
        level_id, 0.1, tau, lo, interior, (XS, YS, ZS),
        tuple(face_bc or (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y,
                          BC_MIRROR_Z, BC_MIRROR_Z)),
        np.zeros((XS, YS, ZS), bool),
        np.zeros((XS, YS, ZS), np.float32),
        np.full((XS, YS, ZS), 100.0, np.float32),
    )


def test_patch_builder_invariants(tmp_path):
    verts = make_icosphere(0.5, subdiv=2)
    save_binary_stl(str(tmp_path / "s.stl"), verts)
    cfg = CaseConfig(
        case_dir=str(tmp_path), stl_file="s.stl", surface_resolution=24,
        num_levels=3, reference_length_for_meshing=1.0, flow_velocity=10.0,
        u_lattice=0.05, steps=1, ramp_steps=1, output_freq=10,
        domain_upstream=1.5, domain_downstream=2.0, domain_lateral=1.5,
        domain_height=1.5, wake_enabled=True,
    )
    mesh = load_mesh(cfg.stl_path)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    patches = build_patches(cfg, mesh, params)
    assert len(patches) == params.num_levels
    # level 1 covers the whole domain
    assert patches[0].lo == (0, 0, 0)
    assert patches[0].interior == (params.nx_coarse, params.ny_coarse, params.nz_coarse)
    for i in range(1, len(patches)):
        c, p = patches[i], patches[i - 1]
        # even alignment
        assert all(v % 2 == 0 for v in c.lo)
        # containment with interpolation margin: parent cells down to
        # (lo-1)//2 - 1 must exist inside the parent interior
        for ax in range(3):
            lo_need = (c.lo[ax] - 1) // 2 - 1
            hi_need = (c.lo[ax] + c.interior[ax]) // 2 + 1
            if c.face_bc[2 * ax] == BC_INTERFACE:
                assert lo_need >= p.lo[ax]
            if c.face_bc[2 * ax + 1] == BC_INTERFACE:
                assert hi_need <= p.lo[ax] + p.interior[ax]
        # y and z are stored unpadded; x only to the device-count multiple
        assert c.padded == c.interior
        # geometry is inside the fine patch
    fin = patches[-1]
    assert fin.obstacle[: fin.interior[0], : fin.interior[1], : fin.interior[2]].any()


def test_bouzidi_dense_matches_sparse(rng):
    X, Y, Z = 16, 16, 120
    nc = 40
    cells = np.unique(
        np.stack([
            rng.integers(4, 12, nc), rng.integers(4, 12, nc),
            rng.integers(40, 80, nc),
        ], 1), axis=0,
    ).astype(np.int32)
    q = np.zeros((len(cells), 27), np.float16)
    mask = rng.random((len(cells), 27)) < 0.3
    q[mask] = rng.uniform(0.05, 1.0, mask.sum()).astype(np.float16)
    q[:, 13] = 0
    bz = BouzidiData(cells[:, 0], cells[:, 1], cells[:, 2], q,
                     np.full((len(cells), 27), -1, np.int32))
    p = _patch((X, Y, Z))
    p.bouzidi = bz
    sp = build_bouzidi_patch_plan(p, 0.001)
    dn = build_bouzidi_dense_plan(p, 0.001)
    f = jnp.asarray(rng.random((27,) + p.padded).astype(np.float32))
    out_sparse = apply_bouzidi(f, sp)
    out_dense = apply_bouzidi_dense(f, dn)
    # dense plan stores f16 coefficients (matching the reference's f16 q_map
    # precision); the sparse plan keeps f32 — tolerance is the f16 ulp
    assert np.allclose(
        np.asarray(out_sparse), np.asarray(out_dense), atol=2e-3, rtol=2e-3
    )
    # untouched slots are bit-identical
    changed = np.asarray(out_sparse) != np.asarray(f)
    assert np.array_equal(
        np.asarray(out_dense)[~changed], np.asarray(f)[~changed]
    )


@pytest.mark.slow  # 360 s on the CPU
def test_production_multichip_dryrun():
    """The production multi-level sharded step (parallel.patch_shard via
    __graft_entry__.dryrun_multichip) on the virtual 8-device CPU mesh:
    asserts sharded == single-device internally."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as g

    g.dryrun_multichip(8)

