"""The port's gather_variant against the kernels of tools/perf_gather_int8.py.

That JAX tool cannot be imported by a test: it has no `__main__` guard, and
importing it builds two 2^24-row DBs and runs its benchmarks. So the two
functions that make its kernels, `gather_variant` and `gather_int32view`,
are lifted out of its source with `ast` and executed in a namespace that
supplies small Q, G, KB and NB and the JAX names they use (`_lifted`); the
file itself is neither imported nor changed. Their Pallas kernels run under
`pltpu.force_tpu_interpret_mode()` for modes dma_only, concat_only and
int32view, compared exactly with the port (on the CPU: the plain version),
negative block ids included (both clamp them to block 0).

The `full` body reads the tool's module-level queries as captured
constants, which JAX refuses ("captures constants ... pass them as
inputs"), so `full` is held against int64 numpy scores of the clamped
blocks (int8 exact; bf16 within 1e-5 * max|score|) and against the port's
gather_block_scores plain version (no scales, every row valid) on the same
blocks, exactly. The sinks are held against numpy's XOR of the selected
blocks' 32-bit words.
"""

import ast
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from merizo_search_tpu_torch.ops import gather, gather_variants
from merizo_search_tpu_torch.tools import perf_gather_int8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "perf_gather_int8.py")
Q, G, KB, NB = 4, 4, 8, 64


def _lifted(**consts):
    """gather_variant and gather_int32view of the JAX tool, executed in a
    namespace of the given constants and the JAX names."""
    with open(TOOL) as fh:
        tree = ast.parse(fh.read(), TOOL)
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("gather_variant", "gather_int32view")]
    assert len(fns) == 2
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "np": np, "D": 128,
          "BLOCK": 128, **consts}
    exec(compile(ast.Module(body=fns, type_ignores=[]), TOOL, "exec"), ns)
    return ns


JAX = _lifted(Q=Q, G=G, KB=KB, NB=NB)


def _data(dtype, seed=0):
    """(q, db [NB*128, 128], bidx [Q, KB] with negative entries) numpy."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        db = rng.integers(-127, 128, size=(NB * 128, 128)).astype(np.int8)
        q = rng.integers(-100, 100, size=(Q, 128)).astype(np.int8)
    else:
        db = np.asarray(jnp.asarray(rng.normal(size=(NB * 128, 128))).astype(jnp.bfloat16))
        q = np.asarray(jnp.asarray(rng.normal(size=(Q, 128))).astype(jnp.bfloat16))
    bidx = rng.integers(0, NB, (Q, KB)).astype(np.int32)
    bidx[1, 0] = bidx[2, 5] = -1          # both packages read block 0 there
    bidx[3, 1] = bidx[3, 0]               # a block twice: its words cancel in the sink
    return q, db, bidx


def _torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy_sink(db, bidx):
    blocks = db.reshape(NB, -1)[np.maximum(bidx, 0).ravel()]
    return int(np.bitwise_xor.reduce(np.ascontiguousarray(blocks).view(np.uint32).ravel()))


def _jax_variant(db, bidx, mode):
    dbr = jnp.asarray(db).reshape(NB, 128, 128)
    with pltpu.force_tpu_interpret_mode():
        if mode == "int32view":
            db32 = jax.lax.bitcast_convert_type(dbr.reshape(NB, 128, 32, 4), jnp.int32)
            return np.asarray(JAX["gather_int32view"]()(jnp.asarray(bidx), *([db32] * G)))
        f = JAX["gather_variant"](dbr, mode)
        return np.asarray(f(jnp.asarray(bidx), *([dbr] * G)))


@pytest.mark.parametrize("dtype, mode", [
    ("int8", "dma_only"), ("int8", "concat_only"), ("int8", "int32view"),
    ("bf16", "dma_only"), ("bf16", "concat_only")])
def test_gather_variant_matches_jax(dtype, mode):
    q, db, bidx = _data(dtype, seed=len(mode))
    want = _jax_variant(db, bidx, mode)
    out, sink = gather_variants.gather_variant(_torch(q), _torch(db), _torch(bidx), mode, G)
    assert want.shape == out.shape == (Q, KB // G, G, 128)
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(sink) == _numpy_sink(db, bidx)


def test_int32view_sums_round_in_block_order():
    """Words near 2^31 make the f32 sums order-dependent: the plain version
    adds block by block from 0, as the JAX kernel does."""
    _, db, bidx = _data("int8", seed=3)
    words = db.view(np.int32).reshape(NB, 128, 32)
    words[:, 0, :] = np.random.default_rng(4).integers(2**30, 2**31 - 1, (NB, 32))
    out, _ = gather_variants.gather_variant(_torch(db[:Q]), _torch(db), _torch(bidx),
                                            "int32view", G)
    np.testing.assert_array_equal(out.numpy(), _jax_variant(db, bidx, "int32view"))
    sel = words[np.maximum(bidx, 0).reshape(Q, KB // G, G), 0].astype(np.float32)
    acc, rev = np.zeros((Q, KB // G, 32), np.float32), np.zeros((Q, KB // G, 32), np.float32)
    for g in range(G):
        acc, rev = acc + sel[:, :, g], rev + sel[:, :, G - 1 - g]
    np.testing.assert_array_equal(out.numpy()[:, :, 0, :32], acc)
    assert (acc != rev).any()             # the data tells the two orders apart
    assert (out.numpy()[..., 32:] == 0).all()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_full_mode_is_exact_phase_c_of_the_clamped_blocks(dtype):
    q, db, bidx = _data(dtype, seed=9)
    out, sink = gather_variants.gather_variant(_torch(q), _torch(db), _torch(bidx), "full", G)
    assert sink is None and out.shape == (Q, KB // G, G, 128)
    blocks = db.reshape(NB, 128, 128)[np.maximum(bidx, 0)]           # [Q, KB, 128, 128]
    if dtype == "int8":
        want = np.einsum("qd,qkrd->qkr", q.astype(np.int64), blocks.astype(np.int64))
        np.testing.assert_array_equal(out.numpy().reshape(Q, KB, 128),
                                      want.astype(np.float32))
    else:
        want = np.einsum("qd,qkrd->qkr", q.astype(np.float64), blocks.astype(np.float64))
        assert np.abs(out.numpy().reshape(Q, KB, 128) - want).max() <= 1e-5 * np.abs(want).max()
    phase_c = gather.gather_block_scores(_torch(q), _torch(db), _torch(np.maximum(bidx, 0)),
                                         NB * 128)
    assert torch.equal(out.reshape(Q, KB * 128), phase_c)


def test_gather_variant_rejects_bad_inputs():
    q = torch.zeros(Q, 128, dtype=torch.bfloat16)
    db = torch.zeros(NB * 128, 128, dtype=torch.bfloat16)
    bidx = torch.zeros(Q, KB, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_variants.gather_variant(q, db, bidx, "dma", G)
    with pytest.raises(ValueError):
        gather_variants.gather_variant(q, db, bidx, "full", 3)          # KB % g
    with pytest.raises(ValueError):
        gather_variants.gather_variant(q, db, bidx.long(), "full", G)
    with pytest.raises(TypeError):
        gather_variants.gather_variant(q, db, bidx, "int32view", G)     # not int8
    with pytest.raises(TypeError):
        gather_variants.gather_variant(q.to(torch.int8), db, bidx, "full", G)


def test_gather_tool_runs_on_cpu(capsys):
    out = perf_gather_int8.main(["--device", "cpu", "--log2-rows", "14", "--q", "4",
                                 "--kb", "4", "--g", "2", "--iters", "1"])
    assert [(r["dtype"], r["mode"]) for r in out["rows"]] == [
        ("int8", "dma_only"), ("int8", "concat_only"), ("int8", "full"),
        ("int8", "int32view"), ("bf16", "dma_only"), ("bf16", "concat_only"),
        ("bf16", "full")]
    assert all(r["library_ms"] is None and r["bound_ms"] > 0 for r in out["rows"])
    assert "not device metrics" in capsys.readouterr().out


def test_tool_bidx_is_the_jax_tools():
    """numpy default_rng(0).integers(0, NB, (Q, KB)), as the JAX tool draws it."""
    got = perf_gather_int8.make_bidx(8, 6, 1000, 0, torch.device("cpu"))
    np.testing.assert_array_equal(
        got.numpy(), np.random.default_rng(0).integers(0, 1000, (8, 6)).astype(np.int32))
