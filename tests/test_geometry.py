import numpy as np
import pytest

from open_ludwig.geometry import (
    load_mesh,
    make_cube,
    make_icosphere,
    save_binary_stl,
)


def test_cube_mesh_properties():
    tris = make_cube(1.0)
    assert tris.shape == (12, 3, 3)
    # total area of unit cube surface = 6
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    assert areas.sum() == pytest.approx(6.0)


def test_cube_normals_outward():
    tris = make_cube(2.0)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    centers = tris.mean(axis=1)
    # outward: normal . center > 0 for a cube centered at origin
    assert np.all(np.einsum("ij,ij->i", n, centers) > 0)


def test_icosphere():
    tris = make_icosphere(0.5, subdiv=2)
    assert tris.shape[0] == 20 * 4**2
    r = np.linalg.norm(tris.reshape(-1, 3), axis=1)
    assert np.allclose(r, 0.5, atol=1e-12)
    # surface area approaches 4 pi r^2
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    assert area == pytest.approx(4 * np.pi * 0.25, rel=0.02)


def test_binary_stl_roundtrip(tmp_path):
    tris = make_icosphere(0.3, center=(1.0, 2.0, 3.0), subdiv=1)
    p = str(tmp_path / "s.stl")
    save_binary_stl(p, tris)
    mesh = load_mesh(p, scale=2.0)
    assert mesh.n_triangles == tris.shape[0]
    assert np.allclose(mesh.vertices, tris * 2.0, atol=1e-5)
    assert mesh.min_bounds[0] == pytest.approx(2 * (1.0 - 0.3), abs=1e-4)
    # unit normals
    assert np.allclose(np.linalg.norm(mesh.normals, axis=1), 1.0, atol=1e-5)


def test_ascii_stl(tmp_path):
    txt = """solid test
facet normal 0 0 1
 outer loop
  vertex 0 0 0
  vertex 1 0 0
  vertex 0 1 0
 endloop
endfacet
endsolid test
"""
    p = tmp_path / "a.stl"
    p.write_text(txt)
    mesh = load_mesh(str(p), scale=3.0)
    assert mesh.n_triangles == 1
    assert mesh.areas[0] == pytest.approx(0.5 * 9.0)
