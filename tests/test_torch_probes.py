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


def _spans(nb, nbt, bpc):
    """The number of steps (nbt blocks each) that each CTA range of bpc
    blocks touches."""
    return [(min(nb, b0 + bpc) - 1) // nbt - b0 // nbt + 1 for b0 in range(0, nb, bpc)]


@pytest.mark.parametrize("nq, nsteps, nbt, qgroups, qtiles", [
    (40, 512, 256, 2, 1),        # 2^24 rows, tile 32768
    (300, 512, 256, 8, 2),
    (256, 512, 256, 8, 1),
    (32, 1, 3907, 1, 1),         # 500,096 rows as one step
    (70, 19, 8, 4, 1),           # tile 1024
    (300, 40, 8, 8, 2),
])
@pytest.mark.parametrize("ctas", [2, 3])
def test_mini_scan_geometry_is_phase_a_geometry(nq, nsteps, nbt, qgroups, qtiles, ctas):
    """mini_scan launches as phase A does over nsteps * nbt blocks: query
    tiles of 32 * qgroups queries (Q not a multiple of 32 rounds up), each
    block in exactly one CTA range, the grid resident at once on 132 SMs."""
    from merizo_search_tpu_torch.ops.blockmax import phase_a_geometry

    nb = nsteps * nbt
    qg, bpc, chunks = probes.geometry(nq, nsteps, nbt, 132, ctas)
    assert (qg, bpc) == phase_a_geometry(nq, nb, 132, ctas)
    assert qg == qgroups and -(-nq // (32 * qg)) == qtiles
    assert (chunks - 1) * bpc < nb <= chunks * bpc
    assert qtiles * chunks <= 132 * ctas


def test_mini_scan_ranges_span_steps_at_the_probe_shape():
    """At 2^24 rows, tile 32768, Q 256 the ranges ignore the 256-block
    steps: a bf16 CTA walks 497 blocks, touching 2 or 3 steps, so the
    "none" heads one CTA sends belong to several steps."""
    nb, nbt = 512 * 256, 256
    _, bpc, chunks = probes.geometry(256, 512, nbt, 132, 2)
    assert bpc == 497 and chunks == 264
    assert set(_spans(nb, nbt, bpc)) == {2, 3}
    _, bpc8, _ = probes.geometry(256, 512, nbt, 132, 3)     # int8: 3 CTAs an SM
    assert bpc8 == 331 and max(_spans(nb, nbt, bpc8)) == 3


def _walk_heads(scores, tile, nslab, bpc):
    """The "none" output as the kernel's walk builds it: each CTA range
    takes its blocks in order, and each block that starts a slab sends its
    rows 0..7 to its own step's output by a max (the kernel's atomicMax),
    whatever step the range began in. scores [Q, N]; returns
    [nsteps, Q, 8]."""
    nq, n = scores.shape
    nbt, slab_blocks = tile // 128, tile // nslab // 128
    nb = n // tile * nbt
    out = np.full((n // tile, nq, 8), -np.inf, np.float32)
    for b0 in range(0, nb, bpc):
        for b in range(b0, min(nb, b0 + bpc)):
            if b % slab_blocks == 0:
                out[b // nbt] = np.maximum(out[b // nbt], scores[:, b * 128:b * 128 + 8])
    return out


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("sms", [3, 1])
def test_mini_scan_none_heads_across_steps_match_jax(dtype, sms):
    """Q = 40, tile 1024 (8 blocks a step), nslab 2, five steps, on a card
    of `sms` SMs: CTA ranges of 7 (3 SMs) or 20 blocks (1 SM) span two or
    more steps. The heads as the walk meets them, block by block into each
    block's own step, equal the JAX mini_scan in interpret mode, and so does
    the port's mini_scan."""
    q, db = _data(dtype, 5 * 1024, q=40, seed=5)
    _, bpc, _ = probes.geometry(40, 5, 8, sms, 2)
    assert max(_spans(40, 8, bpc)) >= 2
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_floor2.mini_scan(jnp.asarray(q), jnp.asarray(db), 1024, 2, "none"))
    _check(_walk_heads(_numpy_scores(q, db), 1024, 2, bpc), want, _numpy_scores(q, db).max(),
           q, db, dtype)
    got, sink = probes.mini_scan(_torch(q), _torch(db), 1024, 2, "none")
    _check(got.numpy(), want, sink, q, db, dtype)


@pytest.mark.parametrize("mode", ["none", "reduce"])
def test_mini_scan_odd_batch_matches_numpy(mode):
    """Q = 300 (two query tiles of 256 on the card, the second ragged) at
    tile 1024: the port against numpy scores (the JAX tool's query tile of
    128 leaves the last 44 queries of such a batch unwritten)."""
    q, db = _data("int8", 6 * 1024, q=300, seed=6)
    got, sink = probes.mini_scan(_torch(q), _torch(db), 1024, 4, mode)
    s = _numpy_scores(q, db)
    if mode == "reduce":
        want = s.reshape(300, 6, 8, 128).max(axis=3).transpose(1, 0, 2)
    else:
        _, bpc, _ = probes.geometry(300, 6, 8, 132, 3)
        want = _walk_heads(s, 1024, 4, bpc)
        np.testing.assert_array_equal(
            want, s.reshape(300, 6, 4, 256)[..., :8].max(axis=2).transpose(1, 0, 2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(sink) == s.max()


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
