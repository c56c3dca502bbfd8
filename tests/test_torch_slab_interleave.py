"""The port's slab_scan against the JAX `scan_v2` of tools/perf_slab_interleave.py.

The JAX tool is imported from this checkout's tools/ (see `_jax_tool`) and
its `scan_v2` runs its Pallas kernel under `pltpu.force_tpu_interpret_mode()`;
the port runs on the CPU, where `slab_scan` takes its plain version. The JAX
kernel reads n_valid from the tool's global N (2^24); the tests set N to an
n_valid below the DB's rows, so the NEG_CAP floor of the blocks past it
shows, and call the function under the tool's jit (`__wrapped__`), which
reads N at each call. Inputs are numpy from a seed. Tolerances: int8 exact
(integer dots below 2^24, scaled by one f32 multiply in both); bf16 within
1e-5 * max|score| (interpret mode sums in another order than the port's
float64 rounded to float32).
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

# imported (so cached) from this checkout before the JAX tool, which puts a
# fixed path at the front of sys.path and imports the JAX package from there
from merizo_search_tpu.ops import pallas_scan
from merizo_search_tpu_torch.ops import blockmax, slab_interleave
from merizo_search_tpu_torch.tools import perf_slab_interleave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
NEG_CAP = np.float32(-3.4e38)


def _jax_tool(name):
    """A JAX tool module from this checkout's tools/, with `merizo_search_tpu`
    the checkout's (imported first, so the tool's own import finds it
    cached). The tool reads sys.argv at import (its Q and tile), so it sees
    no arguments; sys.argv and sys.path are restored afterwards."""
    saved_path, saved_argv = list(sys.path), list(sys.argv)
    sys.path.insert(0, TOOLS)
    sys.argv[:] = sys.argv[:1]
    try:
        mod = importlib.import_module(name)
    finally:
        sys.path[:] = saved_path
        sys.argv[:] = saved_argv
    for m in (mod, pallas_scan, slab_interleave):
        assert os.path.realpath(m.__file__).startswith(os.path.realpath(ROOT) + os.sep), (
            f"{m.__name__} imported from outside the checkout: {m.__file__}")
    return mod


jax_slab = _jax_tool("perf_slab_interleave")


def _data(dtype, n, q, seed=0):
    """(q, db, scales) numpy: bf16 normal rows, or int8 clip(40 x normal)
    with a scale a block (repeated over its 128 rows)."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, 128)).astype(np.float32)
    qs = rng.normal(size=(q, 128)).astype(np.float32)
    if dtype == "bf16":
        cast = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        return cast(qs), cast(db), None
    cast = lambda x: np.clip(np.rint(x * 40), -127, 127).astype(np.int8)
    scales = np.repeat(rng.uniform(0.01, 0.05, n // 128), 128).astype(np.float32)
    return cast(qs), cast(db), scales


def _torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_scan(q, db, scales, n_valid, tile, nslab, monkeypatch):
    monkeypatch.setattr(jax_slab, "N", n_valid)
    with pltpu.force_tpu_interpret_mode():
        bm, sbm = jax_slab.scan_v2.__wrapped__(
            jnp.asarray(q), jnp.asarray(db), tile=tile, nslab=nslab,
            scales=None if scales is None else jnp.asarray(scales))
    return np.asarray(bm), np.asarray(sbm)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nslab", [1, 2, 4])
@pytest.mark.parametrize("qn, n_valid", [(8, 3900), (16, 3000)])
def test_slab_scan_matches_jax_scan_v2(dtype, nslab, qn, n_valid, monkeypatch):
    """tile 1024 over 4096 rows; n_valid 3900 floors the last block, 3000
    the whole last tile (its SBM too)."""
    q, db, scales = _data(dtype, 4096, qn, seed=nslab)
    want_bm, want_sbm = _jax_scan(q, db, scales, n_valid, 1024, nslab, monkeypatch)
    bm, sbm = slab_interleave.slab_scan(_torch(q), _torch(db), n_valid, 1024, nslab,
                                        _torch(scales))
    assert bm.shape == (qn, 32) and sbm.shape == (qn, 4)
    bm, sbm = bm.numpy(), sbm.numpy()
    floored = np.arange(32) * 128 >= n_valid
    assert (bm[:, floored] == NEG_CAP).all() and (want_bm[:, floored] == NEG_CAP).all()
    assert (bm[:, ~floored] > NEG_CAP).all()
    if dtype == "int8":
        np.testing.assert_array_equal(bm, want_bm)
        np.testing.assert_array_equal(sbm, want_sbm)
    else:
        s = q.astype(np.float64) @ db.astype(np.float64).T
        tol = 1e-5 * np.abs(s).max()
        assert np.abs(bm - want_bm).max() <= tol
        assert np.abs(sbm - want_sbm).max() <= tol


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_slab_scan_is_blockmax_without_the_channel_for_every_nslab(dtype):
    q, db, scales = (_torch(x) for x in _data(dtype, 8192, 5, seed=7))
    bm0 = blockmax.blockmax_scan(q, db, 8000, scales=scales)
    for nslab in slab_interleave.NSLABS:
        bm, sbm = slab_interleave.slab_scan(q, db, 8000, 2048, nslab, scales)
        assert torch.equal(bm, bm0)
        assert torch.equal(sbm, bm0.view(5, 4, 16).amax(dim=2))
        bm, none = slab_interleave.slab_scan(q, db, 8000, 2048, nslab, scales, sbm=False)
        assert none is None and torch.equal(bm, bm0)


def test_slab_scan_plain_goes_through_the_db_in_pieces(monkeypatch):
    """The plain version's pieces (PLAIN_ROWS rows each) change nothing."""
    q, db, scales = (_torch(x) for x in _data("int8", 8192, 3, seed=8))
    whole = slab_interleave.slab_scan(q, db, 5000, 1024, 2, scales)
    monkeypatch.setattr(slab_interleave, "PLAIN_ROWS", 2048)
    pieces = slab_interleave.slab_scan(q, db, 5000, 1024, 2, scales)
    assert all(torch.equal(a, b) for a, b in zip(whole, pieces))


def test_slab_scan_rejects_bad_inputs():
    q = torch.zeros(4, 128, dtype=torch.bfloat16)
    db = torch.zeros(4096, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        slab_interleave.slab_scan(q, db, 4096, 1024, 3)         # nslab not instantiated
    with pytest.raises(ValueError):
        slab_interleave.slab_scan(q, db, 4096, 1024, 16)
    with pytest.raises(ValueError):
        slab_interleave.slab_scan(q, db, 4096, 512, 8)          # 64-row slabs
    with pytest.raises(ValueError):
        slab_interleave.slab_scan(q, db[:3000], 3000, 1024, 2)  # rows not whole tiles
    with pytest.raises(ValueError):
        slab_interleave.slab_scan(q.to(torch.int8), db.to(torch.int8), 4096, 1024, 2)
    with pytest.raises(TypeError):
        slab_interleave.slab_scan(q.to(torch.int8), db, 4096, 1024, 2)


def test_slab_tool_runs_on_cpu(capsys):
    out = perf_slab_interleave.main(["--device", "cpu", "--log2-rows", "13", "--q", "8",
                                     "--tiles", "1024,2048", "--nslabs", "1,8,16",
                                     "--n-valid", "8000", "--no-sbm", "--iters", "1"])
    rows = out["rows"]
    # nslab 16 (not a value the kernel takes) is skipped
    slabs = [f"slab tile={t} x{n}{bm}" for t in (1024, 2048) for n in (1, 8)
             for bm in ("", " BM only")]
    assert [r["what"] for r in rows] == (
        ["baseline blockmax_scan", *slabs, "library torch.matmul",
         "baseline blockmax_scan", *slabs, "library torch._int_mm"])
    assert all(r["dbm"] == 0.0 and r["dsbm"] == 0.0 for r in rows if "nslab" in r)
    assert all(r["bound_by"] == "bytes" for r in rows)
    text = capsys.readouterr().out
    assert "not device metrics" in text and "max|dBM| = 0.0" in text
