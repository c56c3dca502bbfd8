"""The harness is driven by data: a cell, a configuration and a metric are
added with new files and BENCHMARK.json entries alone, and run.py's
discovery finds them without an edit to any file that was there."""

import hashlib
import json
import os
import shutil

import pytest

from pb_small import ROOT

from portbench import core


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(root, "portbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_every_cell_resolves_to_its_files():
    found = core.discover(ROOT)
    spec = core.load_spec(ROOT)
    assert set(found) == {w["name"] for w in spec["workloads"]}
    for cell in found.values():
        assert cell["driver"].startswith("portbench/drivers/")
        assert "setup_s" in cell["metrics"]


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    with open(os.path.join(root, "BENCHMARK.json"), "rb") as fh:
        spec_bytes = fh.read()
    # the new files
    cfg = json.load(open(os.path.join(root, "portbench/configs/ted365m_int8_mesh8.json")))
    cfg["name"] = "ted365m_int8_mesh8_q"
    with open(os.path.join(root, "portbench/configs/ted365m_int8_mesh8_q.json"), "w") as fh:
        json.dump(cfg, fh)
    traffic = json.load(open(os.path.join(root, "portbench/workloads/ted365m_int8_mesh8.q256.json")))
    traffic["batch"] = 32
    with open(os.path.join(root, "portbench/workloads/ted365m_int8_mesh8_q.q32.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(root, "portbench/metrics/phase_c_ms.py"), "w") as fh:
        fh.write("def read(run):\n    return None\n")
    # and their entries
    spec = json.loads(spec_bytes)
    spec["configs"].append({"name": "ted365m_int8_mesh8_q", "source": "x",
                            "file": "portbench/configs/ted365m_int8_mesh8_q.json",
                            "reduced": ["rows_held"], "why": "x"})
    spec["workloads"].append({"name": "ted365m_int8_mesh8_q.q32", "config": "ted365m_int8_mesh8_q",
                              "traffic": "q32", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "phase_c_ms", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "kernels", "moves": "queries_per_s",
                              "workloads": ["ted365m_int8_mesh8_q.q32"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    found = core.discover(root)
    new = found["ted365m_int8_mesh8_q.q32"]
    assert new["config"] == "portbench/configs/ted365m_int8_mesh8_q.json"
    assert new["traffic"] == "portbench/workloads/ted365m_int8_mesh8_q.q32.json"
    assert new["metrics"]["phase_c_ms"] == "portbench/metrics/phase_c_ms.py"
    assert "phase_c_ms" not in found["ted365m_int8_mesh8.q256"]["metrics"]
    cell = core.resolve(root, core.load_spec(root), "ted365m_int8_mesh8_q.q32")
    assert cell.traffic["batch"] == 32 and cell.config["name"] == "ted365m_int8_mesh8_q"
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_a_missing_file_is_named(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = core.load_spec(ROOT)
    spec["per_layer"].append({"name": "nowhere_ms", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "x", "moves": "queries_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    with pytest.raises(FileNotFoundError, match="metrics/nowhere_ms.py"):
        core.discover(root)
