"""The in-repo reader and writer of the case-file YAML subset (yamlio)
against PyYAML, on every shipped case file."""

import glob
import os

import pytest
import yaml

from open_ludwig import yamlio
from open_ludwig.config import load_batch_list, load_case_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
CASE_FILES = sorted(glob.glob(os.path.join(ROOT, "CASES", "*", "config.yaml")))


@pytest.mark.parametrize(
    "path", CASE_FILES, ids=[os.path.basename(os.path.dirname(p)) for p in CASE_FILES]
)
def test_reads_case_config_like_pyyaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yamlio.load(path) == want
    cfg = load_case_config(os.path.dirname(path))
    assert cfg.surface_resolution == want["basic"]["surface_resolution"]


def test_reads_batch_list_like_pyyaml():
    path = os.path.join(ROOT, "cases_to_run.yaml")
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yamlio.load(path) == want
    assert load_batch_list(path) == list(want["case_folders"])
    for name in want["case_folders"]:
        assert os.path.isdir(os.path.join(ROOT, "CASES", name))


def test_write_read_round_trip(tmp_path):
    data = {
        "basic": {"stl_file": "a b.stl", "scale": 1.5e-05, "levels": 3,
                  "flag": False, "none": None, "text": "x: y # z",
                  "empty_map": {}, "empty_list": []},
        "list": [0.25, -1, True, "s", None],
        "top": "yes-no",
    }
    path = str(tmp_path / "c.yaml")
    yamlio.dump(data, path)
    assert yamlio.load(path) == data
    with open(path) as f:
        assert yaml.safe_load(f) == data  # the output is plain YAML too
