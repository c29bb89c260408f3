"""Config schema + unit scaling tests against reference-documented values."""

import os
import textwrap

import numpy as np
import pytest

from open_ludwig.config import CaseConfig, load_case_config, parse_config
from open_ludwig.scaling import (
    compute_domain_params,
    compute_max_levels_for_domain,
    compute_tau_fine,
)

SPHERE_YAML = textwrap.dedent(
    """
    basic:
      stl_file: "ball1m.stl"
      stl_scale: 1.0
      surface_resolution: 55
      num_levels: 7
      reference_area_of_full_model: 1.0
      reference_chord: 1.0
      reference_length_for_meshing: 1.0
      reference_dimension: "x"
      fluid:
        density: 1.225
        kinematic_viscosity: 1.5e-5
      flow:
        velocity: 148
      simulation:
        steps: 12000
        ramp_steps: 2000
        output_freq: 3000
        output_dir: "RESULTS"
    advanced:
      numerics:
        u_lattice: 0.03
        c_wale: 0.50
        tau_min: 0.500001
      high_re:
        wall_model:
          enabled: true
      domain:
        upstream: 3.75
        downstream: 4.5
        lateral: 3.75
        height: 3.75
      boundary:
        method: "bouzidi"
      forces:
        enabled: true
        moment_center: [0.25, 0.0, 0.0]
      diagnostics:
        freq: 200
    """
)


@pytest.fixture
def sphere_cfg(tmp_path):
    (tmp_path / "config.yaml").write_text(SPHERE_YAML)
    return load_case_config(str(tmp_path))


def test_config_parsing(sphere_cfg):
    c = sphere_cfg
    assert c.surface_resolution == 55
    assert c.flow_velocity == 148
    assert c.u_lattice == pytest.approx(0.03)
    assert c.wall_model_enabled
    assert c.boundary_method == "bouzidi"
    assert c.moment_center == (0.25, 0.0, 0.0)
    assert c.diag_freq == 200
    assert c.effective_force_output_freq == 200
    # defaults for keys not present
    assert c.nu_sgs_background == pytest.approx(0.0005)
    assert c.temporal_interpolation is True
    assert c.refinement_margin == 2


def test_reference_area_symmetric():
    c = CaseConfig(reference_area_full_model=2.0, symmetric_analysis=True)
    assert c.reference_area == 1.0
    c2 = CaseConfig(reference_area_full_model=2.0, symmetric_analysis=False)
    assert c2.reference_area == 2.0


def test_tau_fine_re1m():
    # Sphere Re = 148*1/1.5e-5 = 9.8667e6?? No: Re1M log has U=14.8.
    # Check the formula itself: nu_lat = u*N/Re; tau = 3 nu + 0.5
    re = 14.8 * 1.0 / 1.5e-5  # 986_666
    tau = compute_tau_fine(re, 55, 0.03)
    nu_lat = 0.03 * 55 / re
    assert tau == pytest.approx(0.5 + 3 * nu_lat)
    assert 0.5 < tau < 0.51


def test_max_levels():
    # domain 8.5 m, dx_fine = 1/55, block 8, min blocks 4
    lv = compute_max_levels_for_domain(8.5, 1 / 55, 8, 4)
    assert lv == int(np.floor(1 + np.log2(8.5 / ((1 / 55) * 32))))


def test_domain_params_sphere(sphere_cfg):
    p = compute_domain_params(sphere_cfg, (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    # num_levels capped by domain, not the configured 7
    assert p.num_levels < 7
    assert p.re_number == pytest.approx(148 / 1.5e-5)
    # tau ladder: coarse tau grows by 2x per level above fine
    for i in range(p.num_levels - 1):
        assert p.tau_levels[i] - 0.5 == pytest.approx(
            (p.tau_fine - 0.5) * 2 ** (p.num_levels - 1 - i), rel=1e-6
        )
    assert p.tau_levels[-1] == pytest.approx(p.tau_fine)
    # grid dims are block multiples
    assert p.nx_coarse % 8 == p.ny_coarse % 8 == p.nz_coarse % 8 == 0
    assert p.bx_max * 8 == p.nx_coarse
    # domain contains the mesh with upstream margin
    assert p.mesh_offset[0] == pytest.approx(3.75 * 1.0 + 0.5)
    # scales
    assert p.velocity_scale == pytest.approx(148 / 0.03)
    assert p.time_scale == pytest.approx(p.dx_fine / p.velocity_scale)
    assert p.force_scale == pytest.approx(1.225 * p.dx_fine**4 / p.time_scale**2)
    # moment center at quarter chord downstream of placed mesh nose
    assert p.moment_center[0] == pytest.approx(-0.5 + p.mesh_offset[0] + 0.25)


def test_dx_levels_monotone(sphere_cfg):
    p = compute_domain_params(sphere_cfg, (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    assert p.dx_levels[-1] == pytest.approx(p.dx_fine)
    for a, b in zip(p.dx_levels, p.dx_levels[1:]):
        assert a == pytest.approx(2 * b)


def test_unit_roundtrip(sphere_cfg):
    p = compute_domain_params(sphere_cfg, (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    # lattice velocity u_lat -> physical: u_lat * velocity_scale == U
    assert 0.03 * p.velocity_scale == pytest.approx(148.0)
    # nu consistency: nu_lat * dx^2/dt == nu_phys
    assert p.nu_lattice * p.length_scale**2 / p.time_scale == pytest.approx(1.5e-5)


def test_auto_levels_and_caps():
    from open_ludwig.config import CaseConfig
    from open_ludwig.scaling import compute_domain_params

    base = dict(
        reference_length_for_meshing=1.0, surface_resolution=32,
        flow_velocity=10.0, u_lattice=0.05,
        domain_upstream=2.0, domain_downstream=2.0,
        domain_lateral=2.0, domain_height=2.0,
    )
    bounds = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    # num_levels=0 + auto_levels: capped by max_levels
    cfg = CaseConfig(num_levels=0, auto_levels=True, max_levels=2, **base)
    p = compute_domain_params(cfg, *bounds)
    assert p.num_levels == 2
    # num_levels=0, no auto: min(8, domain cap)
    cfg = CaseConfig(num_levels=0, auto_levels=False, **base)
    p2 = compute_domain_params(cfg, *bounds)
    assert p2.num_levels >= 2
    # explicit num_levels capped by the domain rule
    cfg = CaseConfig(num_levels=12, **base)
    p3 = compute_domain_params(cfg, *bounds)
    assert p3.num_levels == p2.num_levels  # same geometric cap


def test_tau_floor_applied():
    from open_ludwig.config import CaseConfig
    from open_ludwig.scaling import compute_domain_params

    cfg = CaseConfig(
        num_levels=1, reference_length_for_meshing=1.0, surface_resolution=10,
        flow_velocity=1e6, u_lattice=0.01, tau_min=0.51,
    )
    p = compute_domain_params(cfg, (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    assert p.tau_fine == pytest.approx(0.51)
