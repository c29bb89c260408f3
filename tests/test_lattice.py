"""Lattice invariants the reference never tested (SURVEY.md section 4)."""

import numpy as np

from open_ludwig import lattice as lat


def test_weights_sum_to_one():
    assert np.isclose(lat.W64.sum(), 1.0, atol=1e-15)


def test_first_moment_zero():
    for c in (lat.C_X, lat.C_Y, lat.C_Z):
        assert abs((lat.W64 * c).sum()) < 1e-15


def test_second_moment_isotropy():
    # sum_k w_k c_ka c_kb = cs^2 delta_ab
    cs = np.array([lat.C_X, lat.C_Y, lat.C_Z], np.float64)
    m2 = np.einsum("k,ak,bk->ab", lat.W64, cs, cs)
    assert np.allclose(m2, np.eye(3) / 3.0, atol=1e-14)


def test_ordering_matches_reference():
    # k = (cx+1) + 3(cy+1) + 9(cz+1): rest direction is k=13
    assert lat.C_X[13] == lat.C_Y[13] == lat.C_Z[13] == 0
    assert np.isclose(lat.W64[13], 8 / 27)
    # direction 0 is (-1,-1,-1), direction 26 is (1,1,1)
    assert (lat.C_X[0], lat.C_Y[0], lat.C_Z[0]) == (-1, -1, -1)
    assert (lat.C_X[26], lat.C_Y[26], lat.C_Z[26]) == (1, 1, 1)


def test_opposite_and_mirror_maps():
    for k in range(27):
        o = lat.OPP[k]
        assert lat.C_X[o] == -lat.C_X[k]
        assert lat.C_Y[o] == -lat.C_Y[k]
        assert lat.C_Z[o] == -lat.C_Z[k]
        my = lat.MIRROR_Y[k]
        assert lat.C_X[my] == lat.C_X[k]
        assert lat.C_Y[my] == -lat.C_Y[k]
        assert lat.C_Z[my] == lat.C_Z[k]
        mz = lat.MIRROR_Z[k]
        assert lat.C_Z[mz] == -lat.C_Z[k]
    # involutions
    assert np.all(lat.OPP[lat.OPP] == np.arange(27))
    assert np.all(lat.MIRROR_Y[lat.MIRROR_Y] == np.arange(27))
    assert np.all(lat.MIRROR_Z[lat.MIRROR_Z] == np.arange(27))


def test_equilibrium_moments():
    rho, u = 1.05, np.array([0.03, -0.01, 0.02])
    feq = lat.equilibrium_np(rho, *u)
    assert np.isclose(feq.sum(), rho, rtol=1e-12)
    j = np.array(
        [(feq * lat.C_X).sum(), (feq * lat.C_Y).sum(), (feq * lat.C_Z).sum()]
    )
    assert np.allclose(j / rho, u, rtol=1e-10)
    # second moment: Pi_eq = rho (cs^2 I + u u) exactly for the quadratic eq.
    cs = np.array([lat.C_X, lat.C_Y, lat.C_Z], np.float64)
    pi = np.einsum("k,ak,bk->ab", feq, cs, cs)
    expect = rho * (np.eye(3) / 3 + np.outer(u, u))
    assert np.allclose(pi, expect, atol=1e-12)


def test_reg_matrices_consistent():
    # Regularized reconstruction of a pure-equilibrium field is ~0:
    # Pi(f_eq - feq) = 0 trivially; check REG on a random traceless stress
    rng = np.random.default_rng(0)
    f = lat.equilibrium_np(1.0, 0.05, 0.0, 0.0) + 1e-3 * rng.standard_normal(27)
    feq = lat.equilibrium_np(1.0, 0.05, 0.0, 0.0)
    fneq = f - feq
    pi6 = lat.PI_MAT.astype(np.float64) @ fneq
    freg = lat.REG_MAT.astype(np.float64) @ pi6
    # Reconstructed f_neq preserves the second moment (projection property)
    pi6_rec = lat.PI_MAT.astype(np.float64) @ freg
    # diag part of Q has -cs^2: the projection reproduces traceless+trace parts
    # of Pi for D3Q27 exactly
    assert np.allclose(pi6_rec, pi6, atol=1e-12)


def test_roll_offsets():
    # streaming offset encodes (cz*64 + cy*8 + cx)
    for k in range(27):
        assert lat.OFF[k] == lat.C_Z[k] * 64 + lat.C_Y[k] * 8 + lat.C_X[k]
