"""Process set-up and platform choice: the compile-cache directory, the
stream-collide step picked per platform, the card-only smoke script's
refusal to run without a card, and a main path free of PyYAML."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _python(code, env_extra=None, env_drop=(), cwd=ROOT, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


_CACHE_PROBE = (
    "import jax; from open_ludwig.jax_setup import setup_jax_cache; "
    "p = setup_jax_cache(); print(p); print(jax.config.jax_compilation_cache_dir)"
)


def test_cache_dir_from_environment(tmp_path):
    want = str(tmp_path / "cache")
    r = _python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]


def test_cache_dir_default_is_ignored_checkout_dir():
    r = _python(_CACHE_PROBE, env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(ROOT, ".jax_cache")
    assert r.stdout.split() == [want, want]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_step_picker_raises_for_platform_without_step():
    from open_ludwig.solver_dense import level_step_for

    with pytest.raises(RuntimeError, match="no stream-collide step"):
        level_step_for("metal")


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_step_picker_known_platforms(platform):
    from open_ludwig.ops.triton_step import make_triton_level_step
    from open_ludwig.solver_dense import _xla_level_step, level_step_for

    want = make_triton_level_step if platform == "gpu" else _xla_level_step
    assert level_step_for(platform) is want


def test_step_picker_follows_default_device():
    import jax

    from open_ludwig.solver_dense import _xla_level_step, level_step_for

    with jax.default_device(jax.devices("cpu")[0]):
        assert level_step_for() is _xla_level_step


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No card (or no repository beside the script): a non-zero exit and no
    result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_main_path_runs_without_pyyaml(tmp_path):
    """Case files are written and read, and the runner imports, with PyYAML
    unimportable."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from open_ludwig.cases import make_case_sphere\n"
        "from open_ludwig.config import load_case_config, load_batch_list\n"
        "import open_ludwig.runner\n"
        f"d = make_case_sphere({str(tmp_path)!r}, '1M', surface_resolution=8)\n"
        "cfg = load_case_config(d)\n"
        "assert cfg.surface_resolution == 8, cfg.surface_resolution\n"
        f"print(load_batch_list({os.path.join(ROOT, 'cases_to_run.yaml')!r}))\n"
    )
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "sphere_re1m" in r.stdout
