"""The benchmark never loads JAX or the JAX package.

In a fresh interpreter: load portbench/run.py, every file of the benchmark
(its drivers and metric readers are found by name at run time), and drive
a small run of every cell on the CPU, which imports whatever of the port
the drivers reach; then no loaded module may have the top-level name
`jax`, `jaxlib`, `flax` or `merizo_search_tpu`. Names are compared whole:
the port, `merizo_search_tpu_torch`, begins with the JAX package's name.
"""

import json
import os
import subprocess
import sys

from pb_small import ROOT

CODE = r"""
import glob, json, os, runpy, sys, time
sys.path.insert(0, {tests!r})
import pb_small
from portbench import core
runpy.run_path(os.path.join(pb_small.ROOT, "portbench", "run.py"), run_name="portbench_run")
files = sorted(glob.glob(os.path.join(pb_small.ROOT, "portbench", "**", "*.py"), recursive=True))
files = [f for f in files if os.sep + "tests" + os.sep not in f]
for i, f in enumerate(files):
    core.load_module(f, "pb_import_%d" % i)
for name in (pb_small.TED, pb_small.CATH):
    pb_small.cpu_run(name, 5, seconds=0.2)
print(json.dumps({{"files": len(files), "bad": core.forbidden_modules(),
                  "port": sorted(m for m in sys.modules if m.startswith("merizo_search_tpu_torch."))}}))
"""


def test_the_benchmark_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    tests = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", CODE.format(tests=tests)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["files"] >= 15
    assert out["bad"] == []
    for mod in ("search.engine", "ops.fused_scan", "pipeline.dbsearch", "models.foldclass"):
        assert "merizo_search_tpu_torch." + mod in out["port"]


def test_forbidden_names_are_matched_whole(monkeypatch):
    from portbench import core
    monkeypatch.setitem(sys.modules, "merizo_search_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "merizo_search_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert core.forbidden_modules() == ["jax", "merizo_search_tpu.ops"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ted365m_int8_mesh8.q256",
                          "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr
