"""A short run of every cell on the card (marked `gpu`: skips where there is
no CUDA device, decided at run time), and a checkout without the program,
which must fail without a result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from pb_small import ROOT

from portbench import core


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(root, cell, trace):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                           "--seed", str(2 ** 32 + 3), "--seconds", "2", "--trace", str(trace)],
                          cwd=root, capture_output=True, text=True, timeout=900)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in core.load_spec(ROOT)["workloads"]])
def test_a_traced_run_of_each_cell_is_correct(cell):
    _card()
    res = _run(ROOT, cell, 1)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert list(out)[-1] == "compared"
    want = core.resolve(ROOT, core.load_spec(ROOT), cell).per_layer
    assert set(out["metrics"]) == set(want)
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.gpu
def test_a_checkout_without_the_program_fails(tmp_path):
    _card()
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    res = _run(str(tmp_path), "ted365m_int8_mesh8.q256", 0)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
