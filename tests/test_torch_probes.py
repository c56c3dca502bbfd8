"""The port's floor probes against the JAX package's measurement tools.

`mini_scan` is held against the JAX `mini_scan` of tools/perf_floor2.py
(tile 1024) and of tools/perf_int8_floor.py (its fixed tile of 32768 rows:
one grid step on a 32768-row int8 DB); `stream_probe` against the JAX
`stream_probe` of tools/perf_hbm.py. The JAX tools are imported from this
checkout's tools/ (see `_jax_tool`) and run their Pallas kernels under
`pltpu.force_tpu_interpret_mode()`; the port runs on the CPU, where each
wrapper takes its plain version. Inputs are numpy from a seed. Tolerances:
int8 exact (integer dots below 2^24); bf16 within 1e-5 * max|score|
(interpret mode sums in another order than the port's float64 rounded to
float32); stream_probe exact (sums of small integers). The sinks are held
against numpy.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

# imported (so cached) from this checkout before the JAX tools, which put
# fixed paths at the front of sys.path and import these from there
from merizo_search_tpu.ops import pallas_scan
from merizo_search_tpu_torch.ops import probes
from merizo_search_tpu_torch.tools import perf_floor2, perf_hbm, perf_int8_floor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")


def _jax_tool(name):
    """A JAX tool module from this checkout's tools/, with its `_bench_util`
    and `merizo_search_tpu` the checkout's (imported first, so the tool's own
    imports find them cached). sys.path is restored afterwards: the paths the
    tool inserts do not outlive this call."""
    saved = list(sys.path)
    sys.path.insert(0, TOOLS)
    try:
        bench_util = importlib.import_module("_bench_util")
        mod = importlib.import_module(name)
    finally:
        sys.path[:] = saved
    for m in (bench_util, mod, pallas_scan, probes):
        assert os.path.realpath(m.__file__).startswith(os.path.realpath(ROOT) + os.sep), (
            f"{m.__name__} imported from outside the checkout: {m.__file__}")
    return mod


jax_floor2 = _jax_tool("perf_floor2")
jax_hbm = _jax_tool("perf_hbm")
jax_int8_floor = _jax_tool("perf_int8_floor")


def _data(dtype, n, q=16, seed=0):
    """(q, db) numpy in the storage type: bf16 normal rows (as the tools'
    DB), or int8 clip(40 x normal)."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, 128)).astype(np.float32)
    qs = rng.normal(size=(q, 128)).astype(np.float32)
    if dtype == "int8":
        cast = lambda x: np.clip(np.rint(x * 40), -127, 127).astype(np.int8)
    else:
        cast = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return cast(qs), cast(db)


def _torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy_scores(q, db):
    return (q.astype(np.float64) @ db.astype(np.float64).T).astype(np.float32)


def _check(got, want, sink, q, db, dtype):
    assert got.shape == want.shape
    ref = _numpy_scores(q, db)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
        assert float(sink) == ref.max()
    else:
        tol = 1e-5 * np.abs(ref).max()
        assert np.abs(got - want).max() <= tol
        assert abs(float(sink) - ref.max()) <= tol


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["none", "reduce"])
def test_mini_scan_matches_jax_floor2(dtype, mode):
    q, db = _data(dtype, 4096)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_floor2.mini_scan(jnp.asarray(q), jnp.asarray(db), 1024, 2, mode))
    got, sink = probes.mini_scan(_torch(q), _torch(db), 1024, 2, mode)
    assert got.shape == (4, 16, 8)        # 8 slab-head rows, or 1024/128 blocks
    _check(got.numpy(), want, sink, q, db, dtype)


@pytest.mark.parametrize("mode", ["none", "reduce"])
def test_mini_scan_matches_jax_int8_floor_fixed_tile(mode):
    """perf_int8_floor's fixed tile of 32768 rows: one grid step."""
    q, db = _data("int8", probes.TILE, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_int8_floor.mini_scan(jnp.asarray(q), jnp.asarray(db), 4, mode))
    got, sink = probes.mini_scan(_torch(q), _torch(db), nslab=4, reduce_mode=mode)
    assert got.shape == (1, 16, 8 if mode == "none" else probes.TILE // 128)
    _check(got.numpy(), want, sink, q, db, "int8")


def test_mini_scan_none_mode_keeps_slab_heads():
    """'none' is the max over slabs of the first 8 rows of each slab."""
    q, db = _data("int8", 2048, q=3, seed=2)
    got, _ = probes.mini_scan(_torch(q), _torch(db), 1024, 4, "none")
    s = _numpy_scores(q, db).reshape(3, 2, 4, 256)[..., :8].max(axis=2)
    np.testing.assert_array_equal(got.numpy(), s.transpose(1, 0, 2))


@pytest.mark.parametrize("d, tile", [(128, 1024), (128, 4096), (1024, 512)])
def test_stream_probe_matches_jax(d, tile):
    rng = np.random.default_rng(d + tile)
    x = rng.integers(-127, 128, size=(16384 * 128 // d, d)).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_hbm.stream_probe(jnp.asarray(x), jnp.float32(3.0), tile))
    got, sink = probes.stream_probe(_torch(x), 3.0, tile)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(sink) == int(np.bitwise_xor.reduce(x.view(np.uint32).ravel()))


def test_stream_probe_sink_covers_only_whole_tiles():
    x = np.random.default_rng(4).integers(-127, 128, size=(1000, 128)).astype(np.int8)
    o, sink = probes.stream_probe(_torch(x), 0.0, 300)        # 3 steps: rows < 900
    np.testing.assert_array_equal(
        o.numpy(), x[:900].reshape(3, 300, 128)[:, :8].astype(np.float32).sum(0))
    assert int(sink) == int(np.bitwise_xor.reduce(x[:900].view(np.uint32).ravel()))


def test_probes_reject_bad_inputs():
    q = torch.zeros(4, 128, dtype=torch.bfloat16)
    db = torch.zeros(2048, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        probes.mini_scan(q, db, 1000)                   # tile not a multiple of 128
    with pytest.raises(ValueError):
        probes.mini_scan(q, db, 1024, 16)               # slab of 64 rows
    with pytest.raises(ValueError):
        probes.mini_scan(q, db, 4096)                   # fewer rows than a tile
    with pytest.raises(ValueError):
        probes.mini_scan(q, db, 1024, 1, "max")
    with pytest.raises(TypeError):
        probes.mini_scan(q.to(torch.int8), db, 1024)
    with pytest.raises(TypeError):
        probes.stream_probe(db, 0.0, 1024)              # not int8
    with pytest.raises(ValueError):
        probes.stream_probe(torch.zeros(64, 20, dtype=torch.int8), 0.0, 8)


def test_probe_tools_run_on_cpu(capsys):
    hbm = perf_hbm.main(["--device", "cpu", "--gib", "0.001", "--tiles", "1024,2048",
                         "--wide-tiles", "128", "--iters", "1"])
    assert [r["probe"] for r in hbm["rows"]] == [
        "stream tile=1024", "stream tile=2048", "wide(1024) tile=128", "torch.sum int32"]
    f2 = perf_floor2.main(["--device", "cpu", "--log2-rows", "12", "--q", "8",
                           "--dtypes", "int8,bf16", "--tiles", "1024", "--nslabs", "2,16",
                           "--iters", "1", "--k", "5"])
    # nslab 16 leaves 64-row slabs and is skipped, as the JAX tool skips it
    assert [r["what"] for r in f2["rows"]][:4] == [
        "tile=1024 nslab=2 dot_only", "tile=1024 nslab=2 dot+reduce",
        "phaseA (blockmax_scan)", "full fused_topk k=5"]
    assert len(f2["rows"]) == 8
    i8 = perf_int8_floor.main(["4", "--device", "cpu", "--log2-rows", "15", "--q", "8",
                               "--iters", "1", "--k", "5"])
    assert [r["what"] for r in i8["rows"]][:2] == [
        "tile=32768 nslab=4 dot_only", "tile=32768 nslab=4 dot+reduce"]
    out = capsys.readouterr().out
    assert "best reached read" in out and "not device metrics" in out
