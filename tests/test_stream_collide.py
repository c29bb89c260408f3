"""Block-sparse stream-collide vs the naive dense oracle, plus physics
invariants (equilibrium fixed point, mass behavior)."""

import numpy as np
import pytest

from open_ludwig import lattice as lat
from open_ludwig.core.plan import build_stream_plan
from open_ludwig.core.state import build_level_static, init_level_state
from open_ludwig.config import CaseConfig
from open_ludwig.domain.builder import LevelGeometry, _dense_to_blocks
from open_ludwig.domain import topology as topo
from open_ludwig.ops.stream_collide import stream_collide

from reference_impl import naive_step


def _dense_level(dims, obstacle_d, sponge_d, wall_d, tau):
    """Single fully-dense level covering dims blocks."""
    mask = np.ones(dims, bool)
    coords = topo.blocks_from_mask(mask)
    ptr = topo.build_block_pointer(coords, dims)
    nt = topo.build_neighbor_table(coords, ptr)
    return LevelGeometry(
        level_id=1,
        dx=1.0,
        dt=1.0,
        tau=tau,
        dims=dims,
        coords=coords,
        block_ptr=ptr,
        neighbor_table=nt,
        obstacle=_dense_to_blocks(obstacle_d, coords),
        sponge=_dense_to_blocks(sponge_d, coords).astype(np.float32),
        wall_dist=_dense_to_blocks(wall_d, coords).astype(np.float32),
        bouzidi=None,
    )


def _to_blocks(dense, coords):
    """(C, X, Y, Z) or (X, Y, Z) dense -> (C, nb, 512) / (nb, 512)."""
    if dense.ndim == 3:
        return _dense_to_blocks(dense, coords)
    return np.stack([_dense_to_blocks(dense[c], coords) for c in range(dense.shape[0])])


def _to_dense(blocked, coords, dims):
    X, Y, Z = (d * 8 for d in dims)
    lead = blocked.shape[:-2]
    out = np.zeros(lead + (X, Y, Z), blocked.dtype)
    lf = np.arange(512)
    lx, ly, lz = lf % 8, (lf // 8) % 8, lf // 64
    gx = coords[:, 0, None] * 8 + lx[None, :]
    gy = coords[:, 1, None] * 8 + ly[None, :]
    gz = coords[:, 2, None] * 8 + lz[None, :]
    out[..., gx, gy, gz] = blocked
    return out


def _mk_static(geo, cfg, tau):
    import types

    class P:  # minimal params stub for build_level_static
        nx_coarse = geo.dims[0] * 8
        ny_coarse = geo.dims[1] * 8
        nz_coarse = geo.dims[2] * 8
        tau_levels = (tau,)

    return build_level_static(geo, None, cfg, P)


@pytest.mark.parametrize(
    "wall_model,sponge_blend,inlet_turb",
    [(False, False, 0.0), (True, True, 0.05), (False, True, 0.0)],
)
def test_block_path_matches_dense_oracle(rng, wall_model, sponge_blend, inlet_turb):
    dims = (2, 2, 2)
    X = Y = Z = 16
    tau = 0.52
    # random smooth-ish initial state near equilibrium
    f0 = np.asarray(lat.W64[:, None, None, None]) * (
        1.0 + 0.05 * rng.standard_normal((27, X, Y, Z))
    )
    vel0 = 0.02 * rng.standard_normal((3, X, Y, Z))
    obstacle = np.zeros((X, Y, Z), bool)
    obstacle[6:9, 7:9, 7:10] = True  # blob in the middle
    sponge = np.zeros((X, Y, Z), np.float32)
    sponge[13:, :, :] = np.linspace(0.1, 0.9, 3)[:, None, None]
    wall_d = np.full((X, Y, Z), 100.0, np.float32)
    wall_d[5, 7, 7] = 1.2  # a couple of near-wall cells
    wall_d[9, 8, 8] = 0.8

    u_in, seed = 0.05, 77
    kw = dict(
        u_inlet=u_in,
        t_seed=seed,
        tau=tau,
        c_wale=0.5,
        nu_sgs=0.0005,
        inlet_turb=inlet_turb,
        wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    # oracle: 2 steps in float64
    f_ref, rho_ref, vel_ref = naive_step(f0, vel0, obstacle, sponge, wall_d, **kw)
    f_ref2, rho_ref2, vel_ref2 = naive_step(f_ref, vel_ref, obstacle, sponge, wall_d, **kw)

    # block path
    geo = _dense_level(dims, obstacle, sponge, wall_d, tau)
    cfg = CaseConfig(q_min_threshold=0.001)
    static = _mk_static(geo, cfg, tau)
    import jax.numpy as jnp

    fb = jnp.asarray(_to_blocks(f0.astype(np.float32), geo.coords))
    vb = jnp.asarray(_to_blocks(vel0.astype(np.float32), geo.coords))
    op_kw = dict(
        tau=tau,
        c_wale=0.5,
        nu_sgs_background=0.0005,
        inlet_turbulence=inlet_turb,
        wall_model=wall_model,
        sponge_blend=sponge_blend,
        use_temporal=False,
    )
    f1, r1, v1 = stream_collide(
        fb, vb, jnp.float32(u_in), jnp.int32(seed), static, **op_kw
    )
    f2, r2, v2 = stream_collide(
        f1, v1, jnp.float32(u_in), jnp.int32(seed), static, **op_kw
    )

    f2d = _to_dense(np.asarray(f2), geo.coords, dims)
    r2d = _to_dense(np.asarray(r2), geo.coords, dims)
    v2d = _to_dense(np.asarray(v2), geo.coords, dims)

    assert np.allclose(f2d, f_ref2, atol=2e-5), np.abs(f2d - f_ref2).max()
    assert np.allclose(r2d, rho_ref2, atol=2e-5)
    assert np.allclose(v2d, vel_ref2, atol=2e-5)


def test_equilibrium_is_fixed_point():
    """Uniform rest equilibrium with u_inlet=0 must be exactly stationary,
    including all boundary types."""
    dims = (2, 1, 1)
    obstacle = np.zeros((16, 8, 8), bool)
    sponge = np.zeros((16, 8, 8), np.float32)
    wall_d = np.full((16, 8, 8), 100.0, np.float32)
    geo = _dense_level(dims, obstacle, sponge, wall_d, 0.6)
    static = _mk_static(geo, CaseConfig(), 0.6)
    import jax.numpy as jnp

    st = init_level_state(geo)
    f1, r1, v1 = stream_collide(
        st["f"],
        st["vel"],
        jnp.float32(0.0),
        jnp.int32(0),
        static,
        tau=0.6,
        c_wale=0.5,
        nu_sgs_background=0.0,
        inlet_turbulence=0.0,
        wall_model=False,
        sponge_blend=True,
        use_temporal=False,
    )
    assert np.allclose(np.asarray(f1), np.asarray(st["f"]), atol=1e-7)
    assert np.allclose(np.asarray(r1), 1.0, atol=1e-6)
    assert np.allclose(np.asarray(v1), 0.0, atol=1e-7)


def test_mass_conservation_interior():
    """With no obstacle/sponge and zero inflow, total mass is conserved to
    float accuracy over several steps (boundaries feed equilibrium at u=0,
    which carries the same mass)."""
    rng = np.random.default_rng(3)
    dims = (2, 2, 2)
    obstacle = np.zeros((16, 16, 16), bool)
    sponge = np.zeros((16, 16, 16), np.float32)
    wall_d = np.full((16, 16, 16), 100.0, np.float32)
    geo = _dense_level(dims, obstacle, sponge, wall_d, 0.55)
    static = _mk_static(geo, CaseConfig(), 0.55)
    import jax.numpy as jnp

    f = np.asarray(lat.W, np.float32)[:, None, None] * np.ones(
        (27, 8, 512), np.float32
    )
    # small interior perturbation away from boundaries
    f[:, 0, 300] *= 1.01
    f = jnp.asarray(f)
    v = jnp.zeros((3, 8, 512), jnp.float32)
    m0 = float(np.asarray(f).sum())
    for _ in range(5):
        f, r, v = stream_collide(
            f, v, jnp.float32(0.0), jnp.int32(0), static,
            tau=0.55, c_wale=0.5, nu_sgs_background=0.0, inlet_turbulence=0.0,
            wall_model=False, sponge_blend=False, use_temporal=False,
        )
    m1 = float(np.asarray(f).sum())
    # boundaries exchange equilibrium-at-rest mass; drift stays tiny
    assert abs(m1 - m0) / m0 < 1e-4
