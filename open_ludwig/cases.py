"""Bundled case synthesis: generate ready-to-run case directories (STL +
config.yaml) for the validation geometries — sphere ("ball1m"-class) and cube
("cube1m"-class) virtual wind tunnels matching the reference's case setups
(reference: CASES/ball1m/config.yaml, CASES/cube1m/config.yaml parameters),
with the geometry synthesized (icosphere / hexahedron) instead of shipping
binary assets.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from . import yamlio
from .geometry import make_cube, make_icosphere, save_binary_stl


def _base_config(stl_file: str, **over) -> Dict:
    cfg = {
        "basic": {
            "stl_file": stl_file,
            "stl_scale": 1.0,
            "surface_resolution": over.pop("surface_resolution", 55),
            "num_levels": over.pop("num_levels", 7),
            "reference_area_of_full_model": over.pop("reference_area", 1.0),
            "reference_chord": 1.0,
            "reference_length_for_meshing": 1.0,
            "reference_dimension": "x",
            "fluid": {"density": 1.225, "kinematic_viscosity": 1.5e-5},
            "flow": {"velocity": over.pop("velocity", 14.8)},
            "simulation": {
                "steps": over.pop("steps", 12000),
                "ramp_steps": over.pop("ramp_steps", 2000),
                "output_freq": over.pop("output_freq", 3000),
                "output_dir": "RESULTS",
                "output_fields": {
                    "density": False,
                    "velocity": True,
                    "velocity_magnitude": True,
                    "vorticity": False,
                    "obstacle": True,
                    "level": True,
                    "bouzidi": False,
                },
            },
        },
        "advanced": {
            "numerics": {
                "u_lattice": over.pop("u_lattice", 0.03),
                "c_wale": over.pop("c_wale", 0.5),
                "tau_min": 0.500001,
                "inlet_turbulence_intensity": over.pop("inlet_turbulence", 0.0),
                "precision": over.pop("precision", "float32"),
            },
            "high_re": {
                "wall_model": {"enabled": over.pop("wall_model", True),
                               "type": "equilibrium", "y_plus_target": 100.0},
            },
            "domain": {
                "upstream": over.pop("upstream", 3.75),
                "downstream": over.pop("downstream", 4.5),
                "lateral": over.pop("lateral", 3.75),
                "height": over.pop("height", 3.75),
                "sponge_thickness": 0.10,
            },
            "refinement": {
                "block_size": 8,
                "margin": 2,
                "strategy": "geometry_first",
                "symmetric_analysis": False,
                "wake_enabled": over.pop("wake_enabled", True),
                "wake_length": 0.25,
                "wake_width_factor": 0.1,
                "wake_height_factor": 0.1,
            },
            "boundary": {
                "method": over.pop("boundary_method", "bouzidi"),
                "bouzidi_levels": 1,
                "q_min_threshold": 0.001,
            },
            "forces": {
                "enabled": True,
                "output_freq": 0,
                "moment_center": [0.25, 0.0, 0.0],
            },
            "diagnostics": {"freq": over.pop("diag_freq", 200)},
            "checkpoint": {
                "freq": over.pop("checkpoint_freq", 0),
                "resume": over.pop("checkpoint_resume", False),
            },
        },
    }
    for key, val in over.items():
        raise ValueError(f"unknown case option: {key}={val}")
    return cfg


def make_case_sphere(case_dir: str, re_regime: str = "1M", **over) -> str:
    """Sphere wind tunnel at one of the reference's validated regimes:
    Re 266K / 1M / 10M (reference: RESULTS_SPHERE_RE*.txt setups)."""
    os.makedirs(case_dir, exist_ok=True)
    # wall_model on in ALL regimes: the reference's three validation runs
    # (reference: RESULTS_SPHERE_RE*.txt) all computed wall distances and
    # ran with wall_model.enabled=true (reference: CASES/ball1m/config.yaml)
    presets = {
        "266K": dict(velocity=4.0, surface_resolution=25, wall_model=True),
        "1M": dict(velocity=14.8, surface_resolution=25, wall_model=True),
        "10M": dict(velocity=148.0, surface_resolution=55, wall_model=True),
    }
    opts = dict(presets[re_regime], reference_area=np.pi * 0.25)
    opts.update(over)
    tris = make_icosphere(0.5, center=(0.0, 0.0, 0.0), subdiv=4)
    save_binary_stl(os.path.join(case_dir, "sphere.stl"), tris)
    cfg = _base_config("sphere.stl", **opts)
    yamlio.dump(cfg, os.path.join(case_dir, "config.yaml"))
    return case_dir


def make_case_cube(case_dir: str, **over) -> str:
    os.makedirs(case_dir, exist_ok=True)
    opts = dict(
        velocity=14.0, surface_resolution=50, reference_area=1.0, wall_model=True
    )
    opts.update(over)
    tris = make_cube(1.0, center=(0.0, 0.0, 0.0))
    save_binary_stl(os.path.join(case_dir, "cube.stl"), tris)
    cfg = _base_config("cube.stl", **opts)
    yamlio.dump(cfg, os.path.join(case_dir, "config.yaml"))
    return case_dir


def make_case_wing(case_dir: str, alpha_deg: float = 0.0, **over) -> str:
    """Extruded NACA0012 wing wind tunnel, mirroring the reference's
    Wing_0_deg / Wing_5_deg cases (multi-level refinement + Cl/Cd/Cm)."""
    from .geometry import make_naca_wing

    os.makedirs(case_dir, exist_ok=True)
    opts = dict(
        velocity=30.0,
        surface_resolution=over.pop("surface_resolution", 40),
        reference_area=2.0,  # chord x span
        wall_model=False,
        wake_enabled=True,
    )
    opts.update(over)
    tris = make_naca_wing(chord=1.0, span=2.0, alpha_deg=alpha_deg)
    save_binary_stl(os.path.join(case_dir, "wing.stl"), tris)
    cfg = _base_config("wing.stl", **opts)
    cfg["basic"]["reference_chord"] = 1.0
    yamlio.dump(cfg, os.path.join(case_dir, "config.yaml"))
    return case_dir
