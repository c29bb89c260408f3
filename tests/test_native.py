"""Native (C++) preprocessing kernels vs the vectorized numpy reference."""

import numpy as np
import pytest

from open_ludwig import native
from open_ludwig.domain.bouzidi import compute_bouzidi
from open_ludwig.domain.voxelize import voxelize_dense
from open_ludwig.geometry import make_cube, make_icosphere


@pytest.fixture(scope="module")
def has_native():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    return True


def test_voxelize_native_matches_numpy(has_native):
    dx = 1.0 / 10
    verts = make_icosphere(0.4, center=(1.0, 1.0, 1.0), subdiv=3)
    dims = (20, 20, 20)
    a = voxelize_dense(verts, dx, dims, use_native=True)
    b = voxelize_dense(verts, dx, dims, use_native=False)
    assert np.array_equal(a, b)


def test_voxelize_native_cube(has_native):
    dx = 1.0 / 8
    verts = make_cube(1.0, center=(2.0, 2.0, 2.0))
    a = voxelize_dense(verts, dx, (32, 32, 32), use_native=True)
    b = voxelize_dense(verts, dx, (32, 32, 32), use_native=False)
    assert np.array_equal(a, b)


def test_bouzidi_native_matches_numpy(has_native):
    dx = 1.0 / 12
    verts = make_icosphere(0.4, center=(1.0, 1.0, 1.0), subdiv=3)
    dims = (24, 24, 24)
    active = np.ones(dims, bool)
    a = compute_bouzidi(verts, dx, dims, active, use_native=True)
    b = compute_bouzidi(verts, dx, dims, active, use_native=False)
    assert a.n_boundary_cells == b.n_boundary_cells
    assert np.array_equal(a.cell_gx, b.cell_gx)
    assert np.array_equal(a.cell_gy, b.cell_gy)
    assert np.array_equal(a.cell_gz, b.cell_gz)
    # q values match to f16 storage precision
    qa = a.q_map.astype(np.float32)
    qb = b.q_map.astype(np.float32)
    assert np.allclose(qa, qb, atol=2e-3)
    # same sparsity pattern
    assert np.array_equal(qa > 0, qb > 0)
