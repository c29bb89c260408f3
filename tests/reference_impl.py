"""Naive dense D3Q27 stepper used as a test oracle.

Implements the reference kernel semantics (reference: src/physics_kernels.jl)
directly on a dense (X, Y, Z) grid in float64 numpy, independent of the
production paths.  Slow and simple on purpose.  `naive_iface_plane` is the
matching oracle of the refinement-interface ghost planes (reference:
src/physics_interpolation.jl:16-138).
"""

import numpy as np

from open_ludwig import lattice as lat

# face type codes, as in open_ludwig.core.patch
BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Z, BC_INTERFACE = range(5)
DOMAIN_FACE_BC = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y,
                  BC_MIRROR_Z, BC_MIRROR_Z)

KAPPA = 0.41


def hash_noise(gy, gz, t_seed, salt=1234):
    with np.errstate(over="ignore"):  # the hash wraps around on purpose
        combined = (
            np.int32(gy) * np.int32(374761393)
            + np.int32(gz) * np.int32(668265263)
            + np.int32(t_seed) * np.int32(1274126177)
            + np.int32(salt)
        )
        h = np.uint32(combined)
        h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return float(h & np.uint32(0xFFFF)) / 32768.0 - 1.0


def eq1d(k, u):
    cu = lat.C_X[k] * u
    return lat.W64[k] * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * u * u)


def naive_step(
    f,
    vel_prev,
    obstacle,
    sponge,
    wall_dist,
    *,
    u_inlet,
    t_seed,
    tau,
    c_wale,
    nu_sgs,
    inlet_turb,
    wall_model,
    sponge_blend,
    face_bc=DOMAIN_FACE_BC,
    iface=None,
    lo=(0, 0, 0),
):
    """f: (27, X, Y, Z) float64. Returns (f_out, rho_out, vel_out).

    `face_bc` gives each face's type (x-min, x-max, y-min, y-max, z-min,
    z-max); a source across an x face takes that face's value before a y
    face, before a z face.  `iface` maps each interface face to its ghost
    values (27, A, B) at the destination cell's transverse coordinates
    (naive_iface_plane's layout).  `lo` is the box's global cell offset,
    which seeds the inlet noise."""
    Q, X, Y, Z = f.shape
    f_str = np.zeros_like(f)
    gx, gy, gz = np.meshgrid(
        np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"
    )
    # pull streaming with in-place boundary handling, per cell (slow loops
    # acceptable at test sizes)
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        rolled = np.roll(f[k], (cx, cy, cz), axis=(0, 1, 2))
        f_str[k] = rolled
        # fix cells whose source was outside the domain
        sx, sy, sz = gx - cx, gy - cy, gz - cz
        crossed = [sx < 0, sx >= X]
        crossed += [~(crossed[0] | crossed[1]) & (sy < 0),
                    ~(crossed[0] | crossed[1]) & (sy >= Y)]
        done = crossed[0] | crossed[1] | crossed[2] | crossed[3]
        crossed += [~done & (sz < 0), ~done & (sz >= Z)]
        by_type = {t: np.zeros((X, Y, Z), bool) for t in range(5)}
        for face, m in enumerate(crossed):
            if face_bc[face] == BC_INTERFACE:
                ax = face // 2
                t_idx = [c for a, c in enumerate((gx, gy, gz)) if a != ax]
                plane = iface[face][k]
                f_str[k][m] = plane[t_idx[0][m], t_idx[1][m]]
            else:
                by_type[face_bc[face]] |= m
        inlet, outlet = by_type[BC_INLET], by_type[BC_OUTLET]
        ymir, zmir = by_type[BC_MIRROR_Y], by_type[BC_MIRROR_Z]
        if inlet.any():
            iy = gy[inlet]
            iz = gz[inlet]
            if inlet_turb > 0:
                noise = (
                    np.array([hash_noise(a + 1 + lo[1], b + 1 + lo[2], t_seed)
                              for a, b in zip(iy, iz)])
                    * inlet_turb
                    * u_inlet
                )
            else:
                noise = np.zeros(len(iy))
            u_inst = u_inlet + noise
            cu = lat.C_X[k] * u_inst
            f_str[k][inlet] = lat.W64[k] * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * u_inst**2)
        f_str[k][outlet] = eq1d(k, u_inlet)
        f_str[k][ymir] = f[lat.MIRROR_Y[k]][ymir]
        f_str[k][zmir] = f[lat.MIRROR_Z[k]][zmir]

    f_bb = f_str[lat.OPP]

    rho = np.maximum(f_str.sum(axis=0), 0.01)
    jx = np.einsum("k,kxyz->xyz", lat.C_X.astype(np.float64), f_str)
    jy = np.einsum("k,kxyz->xyz", lat.C_Y.astype(np.float64), f_str)
    jz = np.einsum("k,kxyz->xyz", lat.C_Z.astype(np.float64), f_str)
    inv_rho_raw = 1.0 / rho
    ux, uy, uz = jx * inv_rho_raw, jy * inv_rho_raw, jz * inv_rho_raw

    sp = sponge
    rho_s = rho * (1 - sp) + sp
    ux_s = ux * (1 - sp) + u_inlet * sp
    uy_s = uy * (1 - sp)
    uz_s = uz * (1 - sp)
    if sponge_blend:
        for k in range(27):
            f_str[k] = f_str[k] * (1 - sp) + eq1d(k, u_inlet) * sp

    Fx = np.zeros_like(rho)
    Fy = np.zeros_like(rho)
    Fz = np.zeros_like(rho)
    if wall_model:
        umag = np.sqrt(ux_s**2 + uy_s**2 + uz_s**2)
        nu_visc = (tau - 0.5) / 3.0
        mask = (wall_dist > 0) & (wall_dist < 10.0) & (umag > 1e-6) & (nu_visc > 1e-10)
        for ix, iy, iz in np.argwhere(mask):
            um = umag[ix, iy, iz]
            d = wall_dist[ix, iy, iz]
            u_tau = um * (nu_visc / (d * um + 1e-10)) ** (1 / 7) * (2 * 8.3) ** (-1 / 7)
            u_tau = max(u_tau, 1e-6)
            y_p = u_tau * d / nu_visc
            if y_p > 11.81:
                u_plus = np.log(y_p) / KAPPA + 5.2
                if u_plus > 0.1:
                    u_tau = max(u_tau * (um / u_tau) / u_plus, 1e-6)
            tau_w = rho_s[ix, iy, iz] * u_tau**2
            tau_r = rho_s[ix, iy, iz] * nu_visc * um / d
            if tau_w > tau_r:
                fm = (tau_w - tau_r) / d
                Fx[ix, iy, iz] = -fm * ux_s[ix, iy, iz] / um
                Fy[ix, iy, iz] = -fm * uy_s[ix, iy, iz] / um
                Fz[ix, iy, iz] = -fm * uz_s[ix, iy, iz] / um

    ux_eq = ux_s + 0.5 * Fx * inv_rho_raw
    uy_eq = uy_s + 0.5 * Fy * inv_rho_raw
    uz_eq = uz_s + 0.5 * Fz * inv_rho_raw
    usq_eq = ux_eq**2 + uy_eq**2 + uz_eq**2

    # WALE gradients from vel_prev with self-fallback at domain faces
    def nbr(comp, d):
        dx, dy, dz = d
        arr = vel_prev[comp]
        out = np.roll(arr, (-dx, -dy, -dz), axis=(0, 1, 2))
        # fallback to self where neighbor is outside
        bad = (
            (gx + dx < 0) | (gx + dx >= X)
            | (gy + dy < 0) | (gy + dy >= Y)
            | (gz + dz < 0) | (gz + dz >= Z)
        )
        out[bad] = arr[bad]
        return out

    g = np.zeros((3, 3, X, Y, Z))
    for comp in range(3):
        g[comp, 0] = 0.5 * (nbr(comp, (1, 0, 0)) - nbr(comp, (-1, 0, 0)))
        g[comp, 1] = 0.5 * (nbr(comp, (0, 1, 0)) - nbr(comp, (0, -1, 0)))
        g[comp, 2] = 0.5 * (nbr(comp, (0, 0, 1)) - nbr(comp, (0, 0, -1)))
    g11, g12, g13 = g[0, 0], g[0, 1], g[0, 2]
    g21, g22, g23 = g[1, 0], g[1, 1], g[1, 2]
    g31, g32, g33 = g[2, 0], g[2, 1], g[2, 2]
    gsq = np.einsum("ab...,bc...->ac...", g, g)
    tr = (gsq[0, 0] + gsq[1, 1] + gsq[2, 2]) / 3.0
    Sd11, Sd22, Sd33 = gsq[0, 0] - tr, gsq[1, 1] - tr, gsq[2, 2] - tr
    Sd12 = 0.5 * (gsq[0, 1] + gsq[1, 0])
    Sd13 = 0.5 * (gsq[0, 2] + gsq[2, 0])
    Sd23 = 0.5 * (gsq[1, 2] + gsq[2, 1])
    S12 = 0.5 * (g12 + g21)
    S13 = 0.5 * (g13 + g31)
    S23 = 0.5 * (g23 + g32)
    OP1 = Sd11**2 + Sd22**2 + Sd33**2 + 2 * (Sd12**2 + Sd13**2 + Sd23**2)
    OP2 = g11**2 + g22**2 + g33**2 + 2 * (S12**2 + S13**2 + S23**2)
    nu_eddy = np.zeros_like(OP1)
    m = OP1 > 1e-12
    OP1_32 = OP1 * np.sqrt(OP1)
    OP2_52 = OP2 * OP2 * np.sqrt(np.maximum(OP2, 1e-12))
    denom = OP2_52 + OP1 * np.sqrt(np.sqrt(np.maximum(OP1, 1e-12)))
    m &= denom > 1e-12
    nu_eddy[m] = (c_wale**2) * OP1_32[m] / denom[m]
    nu_eddy = np.maximum(nu_eddy, nu_sgs)
    omega = 1.0 / np.maximum(tau + 3 * nu_eddy, 0.500001)

    cxf = lat.C_X.astype(np.float64)
    cyf = lat.C_Y.astype(np.float64)
    czf = lat.C_Z.astype(np.float64)
    cu = (
        cxf[:, None, None, None] * ux_eq
        + cyf[:, None, None, None] * uy_eq
        + czf[:, None, None, None] * uz_eq
    )
    feq = rho_s * lat.W64[:, None, None, None] * (1 + 3 * cu + 4.5 * cu**2 - 1.5 * usq_eq)
    fneq = f_str - feq
    Pi_xx = np.einsum("k,kxyz->xyz", cxf * cxf, fneq)
    Pi_yy = np.einsum("k,kxyz->xyz", cyf * cyf, fneq)
    Pi_zz = np.einsum("k,kxyz->xyz", czf * czf, fneq)
    Pi_xy = np.einsum("k,kxyz->xyz", cxf * cyf, fneq)
    Pi_yz = np.einsum("k,kxyz->xyz", cyf * czf, fneq)
    Pi_zx = np.einsum("k,kxyz->xyz", czf * cxf, fneq)

    f_out = np.zeros_like(f)
    for k in range(27):
        Qxx = cxf[k] ** 2 - 1 / 3
        Qyy = cyf[k] ** 2 - 1 / 3
        Qzz = czf[k] ** 2 - 1 / 3
        freg = (
            lat.W64[k]
            * 4.5
            * (
                Pi_xx * Qxx + Pi_yy * Qyy + Pi_zz * Qzz
                + 2 * (Pi_xy * cxf[k] * cyf[k] + Pi_yz * cyf[k] * czf[k] + Pi_zx * czf[k] * cxf[k])
            )
        )
        ft = (
            lat.W64[k]
            * 3.0
            * (
                (cxf[k] - ux_s + 3 * cu[k] * cxf[k]) * Fx
                + (cyf[k] - uy_s + 3 * cu[k] * cyf[k]) * Fy
                + (czf[k] - uz_s + 3 * cu[k] * czf[k]) * Fz
            )
        )
        f_out[k] = feq[k] + (1 - omega) * freg + (1 - 0.5 * omega) * ft

    obs = obstacle
    for k in range(27):
        f_out[k][obs] = f_bb[k][obs]
    rho_out = np.where(obs, 1.0, rho_s)
    vel_out = np.stack(
        [np.where(obs, 0.0, ux_s), np.where(obs, 0.0, uy_s), np.where(obs, 0.0, uz_s)]
    )
    return f_out, rho_out, vel_out


def _upsample_index(g, parent_lo, cap):
    """Parent cells (lo, hi) and upper weight of fine global coordinates g
    under the reference's parity-biased corner rule, clamped to the parent
    array (edge replication)."""
    j = g // 2 - 1 - parent_lo
    w_hi = 0.25 + 0.5 * (g % 2)
    return np.clip(j, 0, cap - 1), np.clip(j + 1, 0, cap - 1), w_hi


def naive_iface_plane(face, child_lo, child_interior, child_padded, parent_lo,
                      parent_states, weights, scale):
    """Ghost values (27, A, B) that a child level's face cells pull across
    interface `face`, in float64: the parent's f, rho and u trilinearly
    upsampled (normal lerp at the face, parity-biased transverse rule),
    blended in time as sum_i weights[i] * parent_states[i], then split into
    equilibrium + scale * non-equilibrium.  Entry [k, a, b] is what
    direction k brings into the face cell at transverse coordinates (a, b);
    parent_states hold float64 {"f" (27, ...), "rho", "vel" (3, ...)}."""
    ax = face // 2
    t_axes = [a for a in range(3) if a != ax]
    g_face = (child_lo[ax] - 1 if face % 2 == 0
              else child_lo[ax] + child_interior[ax])
    cap = parent_states[0]["rho"].shape
    n_lo, n_hi, n_w = _upsample_index(np.array(g_face), parent_lo[ax],
                                      cap[ax])
    A, B = child_padded[t_axes[0]], child_padded[t_axes[1]]
    out = np.zeros((27, A, B))
    for k in range(27):
        c = (lat.C_X[k], lat.C_Y[k], lat.C_Z[k])
        ga = child_lo[t_axes[0]] + np.arange(A) - c[t_axes[0]]
        gb = child_lo[t_axes[1]] + np.arange(B) - c[t_axes[1]]
        a0, a1, wa = _upsample_index(ga, parent_lo[t_axes[0]], cap[t_axes[0]])
        b0, b1, wb = _upsample_index(gb, parent_lo[t_axes[1]], cap[t_axes[1]])

        def interp(arr):
            """(..., parent box) -> (..., A, B) trilinear samples."""
            v = 0.0
            for ni, nw in ((n_lo, 1.0 - n_w), (n_hi, n_w)):
                sl = np.take(arr, int(ni), axis=arr.ndim - 3 + ax)
                for ai, aw in ((a0, 1.0 - wa), (a1, wa)):
                    sa = np.take(sl, ai, axis=sl.ndim - 2)
                    for bi, bw in ((b0, 1.0 - wb), (b1, wb)):
                        sb = np.take(sa, bi, axis=sa.ndim - 1)
                        v = v + nw * aw[:, None] * bw[None, :] * sb
            return v

        f_k = sum(w * interp(st["f"][k]) for w, st in zip(weights, parent_states))
        rho = sum(w * interp(st["rho"]) for w, st in zip(weights, parent_states))
        u = [sum(w * interp(st["vel"][d]) for w, st in zip(weights, parent_states))
             for d in range(3)]
        cu = c[0] * u[0] + c[1] * u[1] + c[2] * u[2]
        usq = u[0] ** 2 + u[1] ** 2 + u[2] ** 2
        feq = rho * lat.W64[k] * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * usq)
        out[k] = feq + (f_k - feq) * scale
    return out
