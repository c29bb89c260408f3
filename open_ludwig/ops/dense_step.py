"""Dense-patch fused stream + BC + collide step.

Streaming is a 3-axis roll per direction; every boundary condition is a
masked select on the destination face row (masks are iota comparisons, fused
by XLA into the streaming consumers), so the hot path contains no gathers:

  - inlet: axis-aligned equilibrium with hash-noise turbulence; the
    (1 + 3cu + 4.5cu^2 - 1.5u^2) factor is shared by all nine cx=+1
    directions, so one (YS, ZS) plane serves them all
    (reference: src/physics_kernels.jl:99-104),
  - outlet: equilibrium at u_inlet (reference: :106-113),
  - y/z mirror: f_in[mirror_k] of the destination cell itself — an
    UNSHIFTED read, exactly the reference's free-slip treatment
    (reference: :115-120),
  - refinement interface: per-direction ghost planes trilinearly+temporally
    interpolated from the parent patch with f_neq rescaling, precomputed as
    dense slab upsampling (reference: src/physics_interpolation.jl:16-138 and
    the parity-biased corner rule of its 1-based floor arithmetic).

Collision is the shared ops.collide_math core on the flat (27, N) view.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import lattice as lat
from ..core.patch import (
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
)
from .collide_math import collide, hash_noise, inlet_equilibrium

_W = jnp.asarray(lat.W)

# f-slab einsums on bf16 g-storage: bf16 operands with f32 accumulation.
# The slab data is already bf16-rounded and the operator weights
# (0.25/0.5/0.75/1.0 upsample rows, edge clamps) are exact in bf16; only the
# normal-lerp weights round (<0.4%, the same class as the storage
# quantization).
#
# Every float32-operand contraction of the interface math runs at HIGHEST:
# on the GPU the default and HIGH precisions admit TF32 (about three decimal
# digits), which would put a 1e-3 relative error on rho and u at every
# refinement interface — far above the f32-storage tolerance (2e-5) that the
# step is held to against the float64 oracle.
_HI = jax.lax.Precision.HIGHEST


def _slab_geom(face: int, patch: PatchLevel, parent: PatchLevel) -> Dict:
    """Static slice/pad geometry for one interface face's parent slab."""
    axis = face // 2
    side = face % 2
    t_axes = [ax for ax in range(3) if ax != axis]
    A, B = patch.padded[t_axes[0]], patch.padded[t_axes[1]]
    g_face = (
        patch.lo[axis] - 1 if side == 0
        else patch.lo[axis] + patch.interior[axis]
    )
    p0 = g_face // 2 - 1
    gA0 = patch.lo[t_axes[0]] - 1
    gB0 = patch.lo[t_axes[1]] - 1
    rng = {}
    pads = {}
    for ax in range(3):
        if ax == axis:
            lo_l = p0 - parent.lo[ax]
            want = (lo_l, lo_l + 2)
        else:
            g0 = gA0 if ax == t_axes[0] else gB0
            ln = A + 2 if ax == t_axes[0] else B + 2
            j0 = g0 // 2 - 1
            j1 = (g0 + ln - 1) // 2
            want = (j0 - parent.lo[ax], j1 - parent.lo[ax] + 1)
        hi_cap = parent.padded[ax]
        got = (max(want[0], 0), min(want[1], hi_cap))
        assert got[1] > got[0], (face, ax, want, hi_cap)
        rng[ax] = got
        pads[ax] = (got[0] - want[0], want[1] - got[1])
    return {
        "axis": axis,
        "t_axes": t_axes,
        "A": A,
        "B": B,
        "gA0": gA0,
        "gB0": gB0,
        "w_face": 0.25 + 0.5 * (g_face % 2),
        "rng": rng,
        "pads": pads,
    }


def _clamped_matrix_cols(
    weights_by_parent: list, start: int, width: int, lo_cap: int, hi_cap: int
) -> np.ndarray:
    """Rows of (row, [(parent_cell, weight), ...]) -> (n_rows, width) matrix
    over slab columns [start, start+width), with parent cells outside
    [lo_cap, hi_cap) clamped to the nearest in-range cell (the edge-pad
    semantics of the reference slab extraction)."""
    M = np.zeros((len(weights_by_parent), width), np.float32)
    for i, pairs in enumerate(weights_by_parent):
        for cell, wt in pairs:
            cell = min(max(cell, lo_cap), hi_cap - 1)
            M[i, cell - start] += wt
    return M


def build_iface_mm_plan(patch: PatchLevel, parent: PatchLevel) -> Optional[Dict]:
    """Static plan for interface_planes_pair_mm: per interface-face axis
    group, parent slab slices plus fused linear operators.

    The face-normal endpoint lerp, the trilinear 2x upsampling (parity-biased
    corner rule), the edge-pad clamping, and the per-direction (1 - c) window
    shifts are ALL linear maps along single axes, so they compose into three
    small matrices per axis group: UN (nf, wn) for the normal lerp, UA3 (3,
    A, wa) / UB3 (3, B, wb) for upsample+shift per transverse window class.
    One einsum against these replaces a per-face slice/pad/transpose/
    upsample/shift op chain (on the GPU that chain was 8% slower end to end
    on the headline case).  Slab slices are kept in natural (x, y, z) axis
    order (reference math: src/physics_interpolation.jl:16-138)."""
    need = [f for f in range(6) if patch.face_bc[f] == BC_INTERFACE]
    if not need:
        return None
    PXS, PYS, PZS = parent.padded
    caps = (PXS, PYS, PZS)

    def wide_range(want_lo: int, want_hi: int, ax: int, width: Optional[int] = None):
        """Slice [start, start+width) covering want ∩ [0, cap)."""
        cap = caps[ax]
        start = max(want_lo, 0)
        w = min(want_hi, cap) - start
        if width is not None:
            w = max(w, width)
        w = min(w, cap)
        start = min(start, cap - w)
        return start, w

    groups = []
    for ax in range(3):
        faces = [f for f in need if f // 2 == ax]
        if not faces:
            continue
        geoms = [_slab_geom(f, patch, parent) for f in faces]
        g0 = geoms[0]
        t0, t1 = g0["t_axes"]
        A, B = g0["A"], g0["B"]

        # transverse wants are identical for both faces of the axis
        def t_want(t_ax, g_t0, ln):
            # PARENT-LOCAL parent-cell range (subtract parent.lo: child
            # coordinates are global at the child level, the slab slices the
            # parent's local array)
            j0 = g_t0 // 2 - 1 - parent.lo[t_ax]
            j1 = (g_t0 + ln - 1) // 2 - parent.lo[t_ax]
            return j0, j1 + 1

        wA = t_want(t0, g0["gA0"], A + 2)
        wB = t_want(t1, g0["gB0"], B + 2)
        sA, wa = wide_range(wA[0], wA[1], t0)
        sB, wb = wide_range(wB[0], wB[1], t1)
        # normal ranges differ per face; use one common width
        n_wants = []
        for g in geoms:
            lo_l = g["rng"][ax][0] - g["pads"][ax][0]
            n_wants.append((lo_l, lo_l + 2))
        n_ranges = [wide_range(w0, w1, ax) for (w0, w1) in n_wants]
        wn = max(r[1] for r in n_ranges)
        n_ranges = [wide_range(w0, w1, ax, width=wn) for (w0, w1) in n_wants]

        # per face: slab-local endpoint indices for the normal lerp (two
        # static picks + lerp on the small slab)
        lerp_idx = []
        for g, (w0, w1), (st, _) in zip(geoms, n_wants, n_ranges):
            i0 = min(max(w0, 0), caps[ax] - 1) - st
            i1 = min(max(w0 + 1, 0), caps[ax] - 1) - st
            lerp_idx.append((i0, i1, g["w_face"]))

        # UA/UB: upsample (parity corner rule) x shift-window classes, with
        # edge-pad clamping to the original want range baked into the columns
        def u_class(g_t0, ln_out, t_ax, want, start, width):
            rows = []
            for i in range(ln_out):
                g = g_t0 + i
                jlo = g // 2 - 1 - parent.lo[t_ax]  # parent-LOCAL cell
                w_hi = 0.25 + 0.5 * (g % 2)
                rows.append([(jlo, 1.0 - w_hi), (jlo + 1, w_hi)])
            # clamp to the CLIPPED want range (edge-pad replicates its ends)
            lo_cap = max(want[0], 0)
            hi_cap = min(want[1], caps[t_ax])
            Mfull = _clamped_matrix_cols(rows, start, width, lo_cap, hi_cap)
            ln_win = ln_out - 2
            return np.stack([Mfull[2 - ci : 2 - ci + ln_win] for ci in range(3)])

        UA3 = u_class(g0["gA0"], A + 2, t0, wA, sA, wa)
        UB3 = u_class(g0["gB0"], B + 2, t1, wB, sB, wb)

        slices = []  # per-face (start_x, start_y, start_z) + common sizes
        for (st, _w) in n_ranges:
            s3 = [0, 0, 0]
            s3[ax] = st
            s3[t0] = sA
            s3[t1] = sB
            slices.append(tuple(s3))
        size3 = [0, 0, 0]
        size3[ax] = wn
        size3[t0] = wa
        size3[t1] = wb
        # per-face 2-hot normal-lerp matrix (nf, wn): contracting the slab's
        # normal axis with this inside the big einsum replaces the z-group's
        # pick+lerp chain
        UN2 = np.zeros((len(faces), wn), np.float32)
        for fi, (i0, i1, wf) in enumerate(lerp_idx):
            UN2[fi, i0] += 1.0 - wf
            UN2[fi, i1] += wf
        groups.append(
            {
                "axis": ax,
                "faces": faces,
                "A": A,
                "B": B,
                "starts": slices,
                "sizes": tuple(size3),
                "lerp_idx": lerp_idx,
                "UA3": jnp.asarray(UA3),
                "UB3": jnp.asarray(UB3),
                "UN2": jnp.asarray(UN2),
            }
        )
    return {"groups": groups}


# Einsum per face axis: f = face, n = temporal weight, (z, y, x) = direction
# classes of the k -> (cz, cy, cx) reshape, N = slab normal, (a, b) = slab
# transverse, (A, B) = output plane.  The output dim order is chosen so y/z
# faces come out x-rows-leading directly (no post-transpose); the UN lerp
# contracts jointly with the upsample+shift matrices.
_MM_EINSUM_F = {
    0: "yAa,zBb,fnzyxab->fnzyxAB",  # x faces: A-class = cy, B-class = cz
    1: "xAa,zBb,fnzyxab->fnAzyxB",  # y faces: A-class = cx, B-class = cz
    2: "xAa,yBb,fnzyxab->fnAzyxB",  # z faces: A-class = cx, B-class = cy
}
_MM_EINSUM_S = {  # vel+rho component stack (t): c = A-class, d = B-class
    0: "cAa,dBb,fntab->fntcdAB",
    1: "cAa,dBb,fntab->fntcdAB",
    2: "cAa,dBb,fntab->fntcdAB",
}


def extract_endpoint_slabs(plan: Dict, state: Dict) -> List[Dict]:
    """Per-group endpoint slabs of ONE parent state, the input of
    interface_planes_pair_mm.  The time-stepper CARRIES a step's "new" slabs
    as the next step's "old" ones (solver_dense stashes them under the
    parent state's "_ifsl" key), so the old endpoint is never re-extracted
    and the pre-step parent arrays have no consumer besides the step itself.

    Per group: {"f": (nf, 27, a, b[,N]), "rho": (nf, a, b[,N]),
    "vel": (nf, 3, a, b[,N])} in the storage dtype.  x and y groups are
    lerped to the face plane here; z groups keep the slab's normal axis N,
    which the einsum contracts with the 2-hot UN2 matrix, and their leading
    nf axis is dropped when both z faces share one slab."""
    out = []
    for grp in plan["groups"]:
        ax = grp["axis"]
        sz = grp["sizes"]
        nhot = ax == 2
        merged = nhot and all(s == grp["starts"][0] for s in grp["starts"])

        def one(key, lead, _nhot=nhot, _merged=merged, _grp=grp, _ax=ax):
            starts = _grp["starts"][:1] if _merged else _grp["starts"]
            per_face = []
            for st3, (i0, i1, wf) in zip(starts, _grp["lerp_idx"]):
                sl = jax.lax.dynamic_slice(
                    state[key], (0,) * lead + st3, state[key].shape[:lead] + sz
                )
                if not _nhot:
                    lo = jax.lax.index_in_dim(sl, i0, lead + _ax, keepdims=False)
                    hi = jax.lax.index_in_dim(sl, i1, lead + _ax, keepdims=False)
                    sl = (1.0 - wf) * lo + wf * hi
                per_face.append(sl)
            stk = jnp.stack(per_face)
            return stk[0] if _merged else stk

        out.append(
            {"f": one("f", 1), "rho": one("rho", 0), "vel": one("vel", 1)}
        )
    return out


def interface_planes_pair_mm(
    plan: Dict,
    patch: PatchLevel,
    parent: PatchLevel,
    slabs_old: Optional[List[Dict]],
    slabs_new: List[Dict],
    use_temporal: bool,
) -> Dict[int, jnp.ndarray]:
    """Pre-shifted ghost planes of a child level for BOTH of its sub-steps
    in one parent step, from the parent's endpoint slabs before
    (`slabs_old`) and after (`slabs_new`) that step (extract_endpoint_slabs).

    endpoint slabs -> temporal blend -> trilinear upsample -> feq + f_neq
    rescale -> per-direction (1 - c) shift (reference:
    src/physics_interpolation.jl:16-138), with every linear stage collapsed
    into one einsum per field against build_iface_mm_plan's operators and
    the nonlinear tail one fusable elementwise DAG per axis group.

    Output, float32 f: face -> (n_w, 27, YS, ZS) for x faces and x-rows
    first (n_w, XS, 27, B) for y/z faces; entry [.., k, a, b] is what
    direction k pulls into the face cell at transverse coordinates (a, b).
    n_w = 2 (temporal weights 0.0 and 0.5) with temporal interpolation,
    else 1 shared by both sub-steps."""
    tau_c = parent.tau - 0.5
    tau_f = patch.tau - 0.5
    scale = float(np.clip(tau_f / tau_c, 0.01, 100.0)) if tau_c > 1e-6 else 1.0
    blend = use_temporal and slabs_old is not None
    cv = jnp.asarray(np.array([-1.0, 0.0, 1.0], np.float32))
    out = {}
    is_g_store = slabs_new[0]["f"].dtype == jnp.bfloat16
    for gi, grp in enumerate(plan["groups"]):
        ax = grp["axis"]
        nf = len(grp["faces"])
        nhot = ax == 2
        merged = nhot and all(s == grp["starts"][0] for s in grp["starts"])

        def slab(key, _merged=merged, _gi=gi):
            # old/new on a state axis with the temporal weights (0.0, 0.5)
            # applied in compact slab space (the blend commutes with every
            # linear operator downstream)
            n_sl = slabs_new[_gi][key]
            if not blend:
                return n_sl[None] if _merged else n_sl[:, None]
            o_sl = slabs_old[_gi][key]
            return jnp.stack([o_sl, 0.5 * (o_sl + n_sl)],
                             axis=0 if _merged else 1)

        f_sl, r_sl, v_sl = slab("f"), slab("rho"), slab("vel")
        nw = f_sl.shape[0] if merged else f_sl.shape[1]
        A, B = grp["A"], grp["B"]
        UA3, UB3 = grp["UA3"], grp["UB3"]
        if f_sl.dtype == jnp.bfloat16:
            f_ein = dict(precision=None, preferred_element_type=jnp.float32)
            ua_f, ub_f = UA3.astype(jnp.bfloat16), UB3.astype(jnp.bfloat16)
            un_f = grp["UN2"].astype(jnp.bfloat16)
        else:
            f_ein = dict(precision=_HI)
            ua_f, ub_f, un_f = UA3, UB3, grp["UN2"]
        if nhot:
            a_len, b_len = f_sl.shape[-3], f_sl.shape[-2]
            n_len = f_sl.shape[-1]
            fs = ("" if merged else "f") + "nzyxabN"
            rs = ("" if merged else "f") + "ntabN"
            lead_sh = () if merged else (nf,)
            ein_f = _MM_EINSUM_F[ax].split(",")[0:2]
            f_up = jnp.einsum(
                f"{ein_f[0]},{ein_f[1]},fN,{fs}->fnAzyxB",
                ua_f, ub_f, un_f,
                f_sl.reshape(lead_sh + (nw, 3, 3, 3, a_len, b_len, n_len)),
                **f_ein,
            )
            rv_ax = 1 if merged else 2
            rv = jnp.concatenate(
                [v_sl, jnp.expand_dims(r_sl, rv_ax)], axis=rv_ax
            )
            rv_w = jnp.einsum(
                f"cAa,dBb,fN,{rs}->fntcdAB",
                UA3, UB3, grp["UN2"], rv, precision=_HI,
            )
        else:
            a_len, b_len = f_sl.shape[-2], f_sl.shape[-1]
            f_up = jnp.einsum(
                _MM_EINSUM_F[ax],
                ua_f, ub_f,
                f_sl.reshape((nf, nw, 3, 3, 3, a_len, b_len)),
                **f_ein,
            )
            # vel einsum carries the component axis so rho can ride the same
            # contraction: stack rho under vel as a 4th "component"
            rv = jnp.concatenate([v_sl, r_sl[:, :, None]], axis=2)
            rv_w = jnp.einsum(
                _MM_EINSUM_S[ax], UA3, UB3, rv, precision=_HI,
            )  # (nf, nw, 4, c, d, A, B)

        # arrange the windowed fields onto the direction-class axes; for y/z
        # faces the plane A axis LEADS the classes (x-rows-first output)
        if ax == 0:
            # target (nf, nw, z, y, x, A, B): c = cy, d = cz
            def arrange(x):  # (nf, nw, c, d, A, B)
                return jnp.swapaxes(x, 2, 3)[:, :, :, :, None]

            cx_b = cv[None, None, None, None, :, None, None]
            cy_b = cv[None, None, None, :, None, None, None]
            cz_b = cv[None, None, :, None, None, None, None]
            W_b = jnp.asarray(lat.W.reshape(3, 3, 3))[
                None, None, :, :, :, None, None
            ]
        else:
            # target (nf, nw, A, z, y, x, B)
            if ax == 1:  # c = cx, d = cz
                def arrange(x):
                    # (nf, nw, c, d, A, B) -> (nf, nw, A, d, 1, c, B)
                    return jnp.transpose(x, (0, 1, 4, 3, 2, 5))[
                        :, :, :, :, None
                    ]
            else:  # c = cx, d = cy
                def arrange(x):
                    # -> (nf, nw, A, 1, d, c, B)
                    return jnp.transpose(x, (0, 1, 4, 3, 2, 5))[
                        :, :, :, None
                    ]

            cx_b = cv[None, None, None, None, None, :, None]
            cy_b = cv[None, None, None, None, :, None, None]
            cz_b = cv[None, None, None, :, None, None, None]
            W_b = jnp.asarray(lat.W.reshape(3, 3, 3))[
                None, None, None, :, :, :, None
            ]

        ub = [arrange(rv_w[:, :, t]) for t in range(3)]
        rho_b = arrange(rv_w[:, :, 3])
        cu = cx_b * ub[0] + cy_b * ub[1] + cz_b * ub[2]
        usq = ub[0] * ub[0] + ub[1] * ub[1] + ub[2] * ub[2]
        expr = rho_b * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
        feq = W_b * expr
        # f_up is in STORAGE space (g = f - w for bf16): the +w decode
        # commutes with every row-sum-1 operator, so it is added once here
        f_up = f_up + W_b if is_g_store else f_up
        plane = feq + (f_up - feq) * jnp.float32(scale)
        if ax == 0:
            plane = plane.reshape(nf, nw, 27, A, B)
        else:
            plane = plane.reshape(nf, nw, A, 27, B)
        for i, face in enumerate(grp["faces"]):
            out[face] = plane[i]
    return out


def inlet_factor_plane(patch: PatchLevel, u_inlet, t_seed,
                       inlet_turbulence: float) -> jnp.ndarray:
    """The inlet's shared equilibrium factor over the (YS, ZS) face: cu =
    +u_inst for all nine cx=+1 directions, so f_k = w_k * factor."""
    _, YS, ZS = patch.padded
    gy1 = jax.lax.broadcasted_iota(jnp.int32, (YS, ZS), 0) + (patch.lo[1] + 1)
    gz1 = jax.lax.broadcasted_iota(jnp.int32, (YS, ZS), 1) + (patch.lo[2] + 1)
    if inlet_turbulence > 0.0:
        noise = hash_noise(gy1, gz1, t_seed)
        u_inst = u_inlet + noise * jnp.float32(inlet_turbulence) * u_inlet
    else:
        u_inst = jnp.broadcast_to(u_inlet, (YS, ZS)).astype(jnp.float32)
    return 1.0 + 3.0 * u_inst + 4.5 * u_inst * u_inst - 1.5 * u_inst * u_inst


def dense_stream_collide(
    f: jnp.ndarray,  # (27, XS, YS, ZS)
    vel: jnp.ndarray,  # (3, XS, YS, ZS)
    u_inlet,
    t_seed,
    static: Dict,  # obstacle/sponge/wall_dist flat (N,) device arrays
    patch: PatchLevel,
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    iface: Optional[Dict[int, jnp.ndarray]] = None,  # interface_planes_pair_mm layout
):
    XS, YS, ZS = patch.padded
    X, Y, Z = patch.interior
    N = XS * YS * ZS
    fb = patch.face_bc

    ix = jax.lax.broadcasted_iota(jnp.int32, (XS, 1, 1), 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, (1, YS, 1), 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, (1, 1, ZS), 2)

    inlet_factor = (
        inlet_factor_plane(patch, u_inlet, t_seed, inlet_turbulence)
        if fb[0] == BC_INLET else None
    )
    outlet_vals = inlet_equilibrium(
        jnp.asarray(lat.C_X.astype(np.float32)), _W, u_inlet
    )  # (27,)

    def face_value(k, face):
        """Value array (broadcastable to (XS, YS, ZS)) for direction k pulled
        across `face`."""
        bc = fb[face]
        if bc == BC_INTERFACE:
            # pre-shifted planes: (27, YS, ZS) for x faces, (XS, 27, B) for
            # y/z faces; broadcast over the face axis
            pl = iface[face]
            if face // 2 == 0:
                return pl[k][None, :, :]
            v = pl[:, k, :]
            return v[:, None, :] if face // 2 == 1 else v[:, :, None]
        if bc == BC_INLET:
            return (_W[k] * inlet_factor)[None, :, :]
        if bc == BC_OUTLET:
            return outlet_vals[k]
        if bc == BC_MIRROR_Y:
            return f[int(lat.MIRROR_Y[k])]
        if bc == BC_MIRROR_Z:
            return f[int(lat.MIRROR_Z[k])]
        raise AssertionError(bc)

    streamed = []
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        val = f[k]
        if (cx, cy, cz) != (0, 0, 0):
            val = jnp.roll(val, (cx, cy, cz), axis=(0, 1, 2))
        # masked overrides in reverse precedence (inlet strongest, applied last;
        # reference precedence: inlet > outlet > y-mirror > z-mirror)
        if cz > 0:
            val = jnp.where(iz == 0, face_value(k, 4), val)
        elif cz < 0:
            val = jnp.where(iz == Z - 1, face_value(k, 5), val)
        if cy > 0:
            val = jnp.where(iy == 0, face_value(k, 2), val)
        elif cy < 0:
            val = jnp.where(iy == Y - 1, face_value(k, 3), val)
        if cx < 0:
            val = jnp.where(ix == X - 1, face_value(k, 1), val)
        elif cx > 0:
            val = jnp.where(ix == 0, face_value(k, 0), val)
        streamed.append(val)
    f_str = jnp.stack(streamed).reshape(27, N)

    # velocity face neighbors with self-fallback at every patch face
    # (reference: src/physics_utils.jl:45-70 falls back to the own cell when
    # the neighbor block is missing — true at domain AND interface faces)
    def vel_nbr(dx, dy, dz):
        r = jnp.roll(vel, (-dx, -dy, -dz), axis=(1, 2, 3))
        if dx > 0:
            r = jnp.where(ix == X - 1, vel, r)
        elif dx < 0:
            r = jnp.where(ix == 0, vel, r)
        if dy > 0:
            r = jnp.where(iy == Y - 1, vel, r)
        elif dy < 0:
            r = jnp.where(iy == 0, vel, r)
        if dz > 0:
            r = jnp.where(iz == Z - 1, vel, r)
        elif dz < 0:
            r = jnp.where(iz == 0, vel, r)
        return r.reshape(3, N)

    nbrs = (
        vel_nbr(1, 0, 0),
        vel_nbr(-1, 0, 0),
        vel_nbr(0, 1, 0),
        vel_nbr(0, -1, 0),
        vel_nbr(0, 0, 1),
        vel_nbr(0, 0, -1),
    )

    f_out, rho_out, vel_out = collide(
        f_str,
        nbrs,
        static["obstacle"],
        static["sponge"],
        static["wall_dist"],
        u_inlet,
        tau=patch.tau,
        c_wale=c_wale,
        nu_sgs_background=nu_sgs_background,
        wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    return (
        f_out.reshape(27, XS, YS, ZS),
        rho_out.reshape(XS, YS, ZS),
        vel_out.reshape(3, XS, YS, ZS),
    )


def build_bouzidi_patch_plan(patch: PatchLevel, q_min: float) -> Optional[Dict]:
    """Bouzidi link lists in dense flat index space (f-space idx =
    k*N + (x*YS + y)*ZS + z); see core.plan.build_bouzidi_plan for the
    block-sparse equivalent (reference: src/bouzidi_kernel.jl:13-92)."""
    bz = patch.bouzidi
    if bz is None or bz.n_boundary_cells == 0:
        return None
    XS, YS, ZS = patch.padded
    X, Y, Z = patch.interior
    N = XS * YS * ZS
    x = bz.cell_gx.astype(np.int64)
    y = bz.cell_gy.astype(np.int64)
    z = bz.cell_gz.astype(np.int64)
    cell = (x * YS + y) * ZS + z
    q = bz.q_map.astype(np.float32)

    dst, src_k_l, src_o, ca, cb = [], [], [], [], []
    for k in range(27):
        if k == 13:
            continue
        qv = q[:, k]
        act = (qv > q_min) & (qv <= 1.0)
        if not act.any():
            continue
        sel = np.nonzero(act)[0]
        qs = qv[sel]
        c = cell[sel]
        opp_k = int(lat.OPP[k])
        dst.append(opp_k * N + c)
        src_k_l.append(k * N + c)
        lo = qs < 0.5
        other_hi = opp_k * N + c
        nx = x[sel] + lat.C_X[opp_k]
        ny = y[sel] + lat.C_Y[opp_k]
        nz = z[sel] + lat.C_Z[opp_k]
        inside = (nx >= 0) & (nx < X) & (ny >= 0) & (ny < Y) & (nz >= 0) & (nz < Z)
        ff = (nx * YS + ny) * ZS + nz
        other_lo = np.where(inside, k * N + ff, k * N + c)
        src_o.append(np.where(lo, other_lo, other_hi))
        a = np.where(lo, 2.0 * qs, 1.0 / (2.0 * qs))
        b = np.where(lo, 1.0 - 2.0 * qs, (2.0 * qs - 1.0) / (2.0 * qs))
        ca.append(a.astype(np.float32))
        cb.append(b.astype(np.float32))
    if not dst:
        return None
    return {
        "dst": jnp.asarray(np.concatenate(dst).astype(np.int32)),
        "src_k": jnp.asarray(np.concatenate(src_k_l).astype(np.int32)),
        "src_other": jnp.asarray(np.concatenate(src_o).astype(np.int32)),
        "coef_a": jnp.asarray(np.concatenate(ca)),
        "coef_b": jnp.asarray(np.concatenate(cb)),
    }


def build_bouzidi_dense_plan(patch: PatchLevel, q_min: float) -> Optional[Dict]:
    """Dense sub-box Bouzidi plan: boundary cells cluster in a tight box
    around the geometry, so instead of sparse gathers the correction
    becomes masked elementwise math on a (27, bx, by, bz) q-box +
    one dynamic_update_slice per direction.

    For each direction k with a valid q at a cell (reference:
    src/bouzidi_kernel.jl:38-88):
      q < 0.5 : f_out[opp_k] = 2q f*[k] + (1-2q) f*[k] at x_ff
      q >= 0.5: f_out[opp_k] = 1/(2q) f*[k] + (2q-1)/(2q) f*[opp_k]
    where f* is the uncorrected post-collision field and x_ff = cell + c_opp.
    Encoded as A*f[k] + BLO*f[k]@shift + BHI*f[opp_k] with per-case masks.
    """
    bz = patch.bouzidi
    if bz is None or bz.n_boundary_cells == 0:
        return None
    X, Y, Z = patch.interior
    XS, YS, ZS = patch.padded
    # bounding box of boundary cells, +1 halo for the x_ff shifted reads,
    # clipped to the padded array (asserted inside the interior)
    lo = np.array([bz.cell_gx.min(), bz.cell_gy.min(), bz.cell_gz.min()]) - 1
    hi = np.array([bz.cell_gx.max(), bz.cell_gy.max(), bz.cell_gz.max()]) + 2
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, [XS, YS, ZS])
    bdim = tuple(int(v) for v in (hi - lo))

    q = bz.q_map.astype(np.float32)  # (nc, 27)
    cx = bz.cell_gx - lo[0]
    cy = bz.cell_gy - lo[1]
    cz = bz.cell_gz - lo[2]

    # Compact ONE-array encoding (the Bouzidi link coefficients always sum
    # to 1, so only the f[k](cell) weight a and a branch bit are needed):
    #   val = |S|*f[k](cell) + (1-|S|) * (f[opp_k](cell) if S < 0
    #                                     else f[k](cell+c_opp))
    # S's sign encodes the q >= 0.5 branch; cells with no link have S = 0.
    # Identities per branch (reference: src/bouzidi_kernel.jl:38-88):
    #   q < 0.5 inside : a = 2q,        other = f[k]@x_ff,  coef 1-2q  = 1-a
    #   q < 0.5 outside: a = 1 (folded fallback), coef 0
    #   q >= 0.5       : a = 1/(2q),    other = f[opp_k],   coef (2q-1)/(2q)
    # Relative to the retired (A, B) pair this halves the coefficient HBM
    # traffic per correction (re-read every fine sub-step) and makes
    # a + (1-a) = 1 EXACT even when S is stored bf16 — the rest-state /
    # g-shift invariance no longer depends on rounding two numbers the
    # same way.
    S = np.zeros((27,) + bdim, np.float32)
    for k in range(27):
        if k == 13:
            continue
        qv = q[:, k]
        act = (qv > q_min) & (qv <= 1.0)
        if not act.any():
            continue
        sel = np.nonzero(act)[0]
        qs = qv[sel]
        x, y, z = cx[sel], cy[sel], cz[sel]
        lo_case = qs < 0.5
        # x_ff = cell + c_opp; fall back to f[k] at the cell when outside
        gx = bz.cell_gx[sel] + lat.C_X[int(lat.OPP[k])]
        gy = bz.cell_gy[sel] + lat.C_Y[int(lat.OPP[k])]
        gz = bz.cell_gz[sel] + lat.C_Z[int(lat.OPP[k])]
        inside = (
            (gx >= 0) & (gx < X) & (gy >= 0) & (gy < Y) & (gz >= 0) & (gz < Z)
        )
        # lo outside: a + (1-2q) fallback weight on f[k](cell) collapses to 1
        a = np.where(
            lo_case, np.where(inside, 2.0 * qs, 1.0), 1.0 / (2.0 * qs)
        )
        S[k, x, y, z] = np.where(lo_case, a, -a)
    return {
        "lo": tuple(int(v) for v in lo),
        "dim": bdim,
        "S": jnp.asarray(S),
    }


def apply_bouzidi_dense(f_out: jnp.ndarray, plan: Dict) -> jnp.ndarray:
    """Apply the dense sub-box Bouzidi correction to (27, XS, YS, ZS).

    Works unchanged on bf16 g-storage (ops.storage): the link coefficients
    sum to 1 and w[opp_k] = w[k], so the correction is form-invariant under
    the f - w shift; compute is f32, store is the array's dtype."""
    lx, ly, lz = plan["lo"]
    bx, by, bz_ = plan["dim"]
    box = jax.lax.dynamic_slice(f_out, (0, lx, ly, lz), (27, bx, by, bz_))
    # functional row build (a chained .at[].set would copy the whole box per
    # direction); row j receives the correction of its opposite direction k
    rows = []
    for j in range(27):
        if j == 13:
            rows.append(box[13])
            continue
        k = int(lat.OPP[j])  # the link direction writing into slot j
        cxk, cyk, czk = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        # f[k] at cell + c_opp = roll by +c (roll(a, s)[i] = a[i - s])
        ff = jnp.roll(box[k], (cxk, cyk, czk), axis=(0, 1, 2))
        s = plan["S"][k].astype(jnp.float32)
        a = jnp.abs(s)
        other = jnp.where(s < 0, box[j].astype(jnp.float32),
                          ff.astype(jnp.float32))
        val = (a * box[k].astype(jnp.float32) + (1.0 - a) * other
               ).astype(box.dtype)
        rows.append(jnp.where(s != 0, val, box[j]))
    new_box = jnp.stack(rows)
    return jax.lax.dynamic_update_slice(f_out, new_box, (0, lx, ly, lz))
