"""The port stands alone: it never loads JAX or the JAX package.

tests/conftest.py imports JAX into the test process, so the import check
runs in a fresh interpreter. Module names are matched exactly:
`merizo_search_tpu_torch` itself starts with `merizo_search_tpu`.
"""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "merizo_search_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("cli", "device", "models.foldclass", "pipeline.embed", "pipeline.dbsearch",
              "search.engine", "ops.topk", "ops.blockmax", "ops.gather",
              "ops.fused_scan", "ops._build", "align.native", "db.codecs",
              "io.pdb", "io.mmcif", "io.results", "ops.pipelined", "ops.probes",
              "tools._bench_util", "tools.perf_pipelined", "tools.perf_hbm",
              "tools.perf_int8_floor", "tools.perf_floor2"):
        assert f"merizo_search_tpu_torch.{m}" in mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_port_modules() + ['chip_smoke']!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "             or m == 'merizo_search_tpu' or m.startswith('merizo_search_tpu.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n"] >= 20
    assert out["bad"] == []


def _port_files():
    """Every file of the port package, and chip_smoke.py, which drives it."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        paths += [os.path.join(dirpath, f) for f in files]
    return paths


@pytest.mark.parametrize("pattern", [
    r"merizo_search_tpu(?!_torch)",            # the JAX package, by name
    r"^\s*(import|from)\s+jax(lib)?\b",        # a JAX import
])
def test_no_port_file_names_the_jax_package(pattern):
    rx = re.compile(pattern, re.M)
    hits = []
    for path in _port_files():
        if os.path.basename(path) == "chip_smoke.py":
            continue      # names the TPU kernels it replaces; held by the test below
        with open(path, encoding="utf-8", errors="replace") as fh:
            if rx.search(fh.read()):
                hits.append(os.path.relpath(path, ROOT))
    assert hits == []


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+merizo_search_tpu(?!_torch)\b",   # an import of the JAX package
    r"^\s*(import|from)\s+jax(lib)?\b",                    # a JAX import
    r"import_module\(\s*[\"']jax|import_module\(\s*[\"']merizo_search_tpu[\"'.]",
])
def test_chip_smoke_imports_neither_jax_nor_the_jax_package(pattern):
    """chip_smoke.py may name the TPU kernels' files as strings (its kernel
    table says which kernel each CUDA kernel replaces), but imports neither."""
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as fh:
        src = fh.read()
    assert "merizo_search_tpu_torch" in src
    assert re.search(pattern, src, re.M) is None
