"""Fused stream-collide step of one dense patch level, as one GPU kernel.

Pallas through Triton (`backend="triton"`): the step has no matrix product,
so it is pure memory traffic, and the one thing a kernel can do better than
XLA's fusions is to read f once and write it once.  The plain XLA step
(ops.dense_step.dense_stream_collide) decodes f to float32, stacks 27
streamed copies and reduces over them; here every value stays in registers.

Layout: every per-cell array is viewed flat, cell n = (x*YS + y)*ZS + z.
One program owns BLOCK consecutive cells.  For each direction k it pulls
f_in[k] at n - (cx*YS*ZS + cy*ZS + cz) into registers (pull streaming, from
f_in into a separate f_out: the scan carry with donation does the A-B swap;
programs run in no order, so an in-place update would race).  A read that
crosses a patch face is replaced by the face's value, with the XLA step's
precedence (x over y over z):

  - refinement interface: the pre-shifted ghost plane of that face
    (ops.dense_step.interface_planes_pair_mm layout),
  - inlet: w_k times the shared inlet factor plane,
  - outlet: the equilibrium at u_inlet,
  - y/z mirror: f_in[mirror_k] of the destination cell itself.

Those loads are masked to the face cells, so a program away from every
face touches no plane.  The six face-neighbour velocities of the WALE
gradient fall back to the cell's own velocity at every patch face.  The
collision is collide_math.collide_fields, the physics the XLA step and the
float64 oracle check; bf16 g-storage is decoded and encoded in registers
(ops.storage).

Over an x-slab device mesh the step runs under `shard_map`: each device
steps its own slab, and the one f and velocity plane that crosses each slab
boundary arrives by `ppermute` as a halo input of the kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.sharding import Mesh, PartitionSpec as P

from .. import lattice as lat
from ..core.patch import (
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
)
from . import storage
from .collide_math import collide_fields
from .dense_step import inlet_factor_plane

# cells per program and warps per program: one cell per thread.  On an
# H100 (700 W) 128 beat 256 and 512 (8 warps) end to end, by 4% on the
# 3-level sphere case and 14% on a 62.5M-cell box.
BLOCK = 128
NUM_WARPS = 4


def _kernel_call(cfg, patch: PatchLevel, xl: int, halo: bool, block: int,
                 num_warps: int, interpret: bool):
    """pallas_call of the step over a slab of `xl` x-planes of `patch`
    (all of them without `halo`).  Inputs: u_inlet (1,), x0 (1,) (the slab's
    first global x-plane), f (27, n) stored, vel (3, n), obstacle int8 (n,),
    sponge (n,), wall (n,), [inlet factor (YS, ZS)], interface planes in face
    order, and with `halo` the f (27, YS*ZS) and vel (3, YS*ZS) planes just
    below and just above the slab.  Outputs f (27, n) stored, rho (n,), vel
    (3, n), with n = xl*YS*ZS."""
    _, YS, ZS = patch.padded
    X, Y, Z = patch.interior
    PL = YS * ZS
    N = xl * PL
    fb = patch.face_bc
    precision = storage.normalize_precision(cfg.precision)
    store_dt = storage.f_dtype(precision)
    g_store = precision == storage.STORE_BF16
    W = [float(w) for w in lat.W64]
    C = [(int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])) for k in range(27)]
    iface_faces = [fc for fc in range(6) if fb[fc] == BC_INTERFACE]
    has_inlet = fb[0] == BC_INLET
    coll = dict(
        tau=patch.tau, c_wale=cfg.c_wale,
        nu_sgs_background=cfg.nu_sgs_background,
        wall_model=cfg.wall_model_enabled,
        sponge_blend=cfg.sponge_blend_distributions,
    )

    def kernel(u_ref, x0_ref, f_ref, v_ref, obs_ref, sp_ref, wd_ref, *refs):
        refs = list(refs)
        inlet_ref = refs.pop(0) if has_inlet else None
        planes = {fc: refs.pop(0) for fc in iface_faces}
        if halo:
            f_lo, f_hi, v_lo, v_hi = refs[:4]
            refs = refs[4:]
        fo_ref, rho_ref, vo_ref = refs

        n = pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
        valid = n < N
        ix = n // PL
        rem = n - ix * PL
        iy = rem // ZS
        iz = rem - iy * ZS
        gx = ix + x0_ref[0]
        u_in = u_ref[0]
        at_face = {
            0: gx == 0, 1: gx == X - 1, 2: iy == 0, 3: iy == Y - 1,
            4: iz == 0, 5: iz == Z - 1,
        }

        def decode(k, v):
            v = v.astype(jnp.float32)
            return v + W[k] if g_store else v

        def load_f(k, idx, mask):
            return decode(k, plgpu.load(f_ref.at[k, idx], mask=mask, other=0.0))

        def pull(k, src):
            """f_in[k] at flat index src, from the halo planes beyond the
            slab's x ends."""
            val = load_f(k, src, valid & (src >= 0) & (src < N))
            if halo and C[k][0] > 0:
                below = src < 0
                h = plgpu.load(f_lo.at[k, src + PL],
                               mask=valid & below & (src >= -PL), other=0.0)
                val = jnp.where(below, decode(k, h), val)
            elif halo and C[k][0] < 0:
                above = src >= N
                h = plgpu.load(f_hi.at[k, src - N],
                               mask=valid & above & (src < N + PL), other=0.0)
                val = jnp.where(above, decode(k, h), val)
            return val

        inlet_factor = None
        if has_inlet:
            inlet_factor = plgpu.load(
                inlet_ref.at[iy, iz], mask=valid & at_face[0], other=0.0)

        def face_value(k, fc):
            bc = fb[fc]
            m = valid & at_face[fc]
            if bc == BC_INTERFACE:
                idx = {0: (k, iy, iz), 1: (k, iy, iz), 2: (ix, k, iz),
                       3: (ix, k, iz), 4: (ix, k, iy), 5: (ix, k, iy)}[fc]
                return plgpu.load(planes[fc].at[idx], mask=m, other=0.0)
            if bc == BC_INLET:
                return W[k] * inlet_factor
            if bc == BC_OUTLET:
                cu = C[k][0] * u_in
                return W[k] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * u_in * u_in)
            if bc == BC_MIRROR_Y:
                return load_f(int(lat.MIRROR_Y[k]), n, m)
            if bc == BC_MIRROR_Z:
                return load_f(int(lat.MIRROR_Z[k]), n, m)
            raise AssertionError(bc)

        f_str = []
        for k in range(27):
            cx, cy, cz = C[k]
            val = pull(k, n - (cx * PL + cy * ZS + cz))
            # masked overrides in reverse precedence (inlet strongest)
            for axis, c in ((2, cz), (1, cy), (0, cx)):
                if c:
                    fc = 2 * axis + (0 if c > 0 else 1)
                    val = jnp.where(at_face[fc], face_value(k, fc), val)
            f_str.append(val)

        vel = [plgpu.load(v_ref.at[c, n], mask=valid, other=0.0) for c in range(3)]

        def vel_nbr(d, fc):
            """Velocity at n + d, the cell's own across face fc."""
            inner = valid & jnp.logical_not(at_face[fc])
            out = []
            for c in range(3):
                src = n + d
                v = plgpu.load(v_ref.at[c, src],
                               mask=inner & (src >= 0) & (src < N), other=0.0)
                if halo and d == PL:
                    v = jnp.where(src >= N, plgpu.load(
                        v_hi.at[c, src - N], mask=inner & (src >= N), other=0.0), v)
                elif halo and d == -PL:
                    v = jnp.where(src < 0, plgpu.load(
                        v_lo.at[c, src + PL], mask=inner & (src < 0), other=0.0), v)
                out.append(jnp.where(at_face[fc], vel[c], v))
            return tuple(out)

        nbrs = (vel_nbr(PL, 1), vel_nbr(-PL, 0), vel_nbr(ZS, 3),
                vel_nbr(-ZS, 2), vel_nbr(1, 5), vel_nbr(-1, 4))
        obstacle = plgpu.load(obs_ref.at[n], mask=valid, other=0) != 0
        sponge = plgpu.load(sp_ref.at[n], mask=valid, other=0.0)
        wall = plgpu.load(wd_ref.at[n], mask=valid, other=100.0)

        f_out, rho, (ux, uy, uz) = collide_fields(
            f_str, nbrs, obstacle, sponge, wall, u_in, **coll)
        for k in range(27):
            out = f_out[k] - W[k] if g_store else f_out[k]
            plgpu.store(fo_ref.at[k, n], out.astype(store_dt), mask=valid)
        plgpu.store(rho_ref.at[n], rho, mask=valid)
        for c, u in enumerate((ux, uy, uz)):
            plgpu.store(vo_ref.at[c, n], u, mask=valid)

    return pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((27, N), store_dt),
            jax.ShapeDtypeStruct((N,), jnp.float32),
            jax.ShapeDtypeStruct((3, N), jnp.float32),
        ),
        grid=(pl.cdiv(N, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name=f"stream_collide_l{patch.level_id}",
    )


def make_triton_level_step(
    cfg, patch: PatchLevel, mesh: Optional[Mesh] = None, *,
    block: int = BLOCK, num_warps: int = NUM_WARPS, interpret: bool = False,
) -> Callable:
    """The stream-collide of one level on stored f, with the signature of
    solver_dense's level steps: step(f, vel, u_inlet, t_seed, static, iface)
    -> (f_new stored, rho, vel_new).  With `mesh` (a 1-D mesh over axis
    "x") each device steps its x-slab.  `interpret` runs the kernel in the
    Pallas interpreter (CPU tests only)."""
    XS, YS, ZS = patch.padded
    PL = YS * ZS
    n_dev = mesh.size if mesh is not None else 1
    if XS % n_dev:
        raise ValueError(f"x extent {XS} does not split over {n_dev} devices")
    xl = XS // n_dev
    halo = mesh is not None
    call = _kernel_call(cfg, patch, xl, halo, block, num_warps, interpret)
    fb = patch.face_bc
    iface_faces = [fc for fc in range(6) if fb[fc] == BC_INTERFACE]

    def slab_step(u, x0, f, vel, obstacle, sponge, wall, extra):
        """One slab: f (27, xl, YS, ZS), vel (3, xl, YS, ZS), flat statics."""
        ins = [u, x0, f.reshape(27, -1), vel.reshape(3, -1),
               obstacle.astype(jnp.int8), sponge, wall, *extra]
        if halo:
            up = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            down = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            ins += [
                jax.lax.ppermute(f[:, -1].reshape(27, PL), "x", up),
                jax.lax.ppermute(f[:, 0].reshape(27, PL), "x", down),
                jax.lax.ppermute(vel[:, -1].reshape(3, PL), "x", up),
                jax.lax.ppermute(vel[:, 0].reshape(3, PL), "x", down),
            ]
        f_new, rho, vel_new = call(*ins)
        return (f_new.reshape(f.shape), rho.reshape(f.shape[1:]),
                vel_new.reshape(vel.shape))

    def step(f, vel, u_inlet, t_seed, static, iface):
        u = jnp.reshape(jnp.asarray(u_inlet, jnp.float32), (1,))
        extra = []
        if fb[0] == BC_INLET:
            extra.append(inlet_factor_plane(
                patch, u[0], t_seed, cfg.inlet_turbulence_intensity))
        extra += [iface[fc].astype(jnp.float32) for fc in iface_faces]
        args = (u, f, vel, static["obstacle"], static["sponge"],
                static["wall_dist"])
        if not halo:
            return slab_step(u, jnp.zeros((1,), jnp.int32), *args[1:], extra)

        def sharded(u, f, vel, obstacle, sponge, wall, extra):
            x0 = (jax.lax.axis_index("x") * xl).astype(jnp.int32).reshape(1)
            return slab_step(u, x0, f, vel, obstacle, sponge, wall, extra)

        # x-face planes and the inlet plane are whole on every device; y/z
        # face planes lead with x and split with the slabs
        extra_specs = ([P()] if fb[0] == BC_INLET else []) + [
            P() if fc < 2 else P("x") for fc in iface_faces]
        return jax.shard_map(
            sharded, mesh=mesh,
            in_specs=(P(), P(None, "x"), P(None, "x"), P("x"), P("x"),
                      P("x"), extra_specs),
            out_specs=(P(None, "x"), P("x"), P(None, "x")),
            check_vma=False,
        )(*args, extra)

    return step
