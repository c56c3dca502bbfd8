"""The port's two-batch pipelined scan against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. The
JAX `fused_topk_step` and `blockmax_scan_gather` run their Pallas kernel
(TPU DMA and semaphores) under `pltpu.force_tpu_interpret_mode()`, and the
JAX `fused_topk` in interpret mode; the port runs on the CPU, where
`blockmax_scan_gather` takes its plain version. Shapes stay inside the JAX
kernel's regime (grid steps >= padded queries, the superblock select):
N = 16384, Q = 16, k = 5, tile 1024 for bf16 and 512 for int8 (whose
queries the JAX step pads to 32). Tolerances:
- bf16 scores within 1e-5 * max(1, |s|): interpret mode sums the 128
  products in another order than the port's float64 rounded to float32;
- int8 scores exact: integer dots below 2^24 and the same float32 multiply
  by the block scale;
- indices equal, except among scores tied within that tolerance;
- the port's pipelined results equal its sequential fused_topk exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from merizo_search_tpu.ops import pallas_scan as jps
from merizo_search_tpu_torch.ops import pipelined, topk
from merizo_search_tpu_torch.ops.fused_scan import fused_topk, selected_scales
from merizo_search_tpu_torch.tools import perf_pipelined

N, Q, K = 16384, 16, 5
N_VALID = N - 100            # off a block edge: one straddling block
TILE = {"bf16": 1024, "int8": 512}
NEG_CAP = np.float32(-3.4e38)


def _unit(rng, n):
    x = rng.normal(size=(n, 128)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _make(dtype):
    """(db, scales, [q0, q1, q2]) as numpy in the storage type."""
    rng = np.random.default_rng(23)
    db = _unit(rng, N)
    qs = [_unit(rng, Q) for _ in range(3)]
    if dtype == "int8":
        db8, scales = topk.quantize_blocks(db)
        return db8, scales, [topk.quantize_rows(q)[0] for q in qs]
    to = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return to(db), None, [to(q) for q in qs]


@pytest.fixture(scope="module", params=["bf16", "int8"])
def runs(request):
    """Both packages' step chains (3 batches plus a drain) and sequential
    scans of each batch, computed once per dtype."""
    dtype = request.param
    db, scales, qs = _make(dtype)
    batches = [qs[0], qs[1], qs[2], qs[2]]
    port, carry = [], None
    for b in batches:
        (v, i), carry = pipelined.fused_topk_step(_torch(b), _torch(db), N_VALID, K,
                                                  carry, scales=_torch(scales))
        port.append((v.numpy(), i.numpy()))
    jax_chain, carry = [], None
    with pltpu.force_tpu_interpret_mode():
        for b in batches:
            (v, i), carry = jps.fused_topk_step(_jax(b), _jax(db), N_VALID, K, carry,
                                                tile=TILE[dtype], scales=_jax(scales))
            jax_chain.append((np.asarray(v), np.asarray(i)))
    jax_seq = [tuple(np.asarray(a) for a in jps.fused_topk(
        _jax(b), _jax(db), N_VALID, K, tile=TILE[dtype], interpret=True,
        scales=_jax(scales))) for b in qs]
    port_seq = [tuple(a.numpy() for a in fused_topk(_torch(b), _torch(db), N_VALID, K,
                                                     scales=_torch(scales))) for b in qs]
    return dict(dtype=dtype, db=db, scales=scales, qs=qs, port=port,
                jax_chain=jax_chain, jax_seq=jax_seq, port_seq=port_seq)


def _tol(v):
    return 1e-5 * np.maximum(1.0, np.abs(np.where(np.isfinite(v), v, 0.0)))


def _assert_same_topk(v1, i1, v2, i2, exact):
    """Scores agree (exactly, or within _tol); indices agree position by
    position except inside runs of tied scores, compared as sets."""
    np.testing.assert_array_equal(np.isfinite(v1), np.isfinite(v2))
    fin = np.isfinite(v2)
    if exact:
        np.testing.assert_array_equal(v1, v2)
    else:
        assert (np.abs(v1[fin] - v2[fin]) <= _tol(v2)[fin]).all()
    tol = _tol(v2)
    for r in range(v1.shape[0]):
        j = 0
        while j < v1.shape[1]:
            e = j + 1
            while e < v1.shape[1] and abs(v2[r, e] - v2[r, j]) <= tol[r, j]:
                e += 1
            if e == v1.shape[1] and e - j > 1:   # a tie run at the cut: any subset
                assert len(set(i1[r, j:e])) == e - j
            else:
                assert set(i1[r, j:e]) == set(i2[r, j:e]), (r, j)
            j = e


def test_first_step_returns_the_all_miss_primer(runs):
    for v, i in (runs["port"][0], runs["jax_chain"][0]):
        assert (v == -np.inf).all() and (i == -1).all()
    assert runs["port"][0][0].shape == (Q, K)


def test_step_chain_matches_jax_step_chain(runs):
    for b in range(1, 4):
        (pv, pi), (jv, ji) = runs["port"][b], runs["jax_chain"][b]
        _assert_same_topk(pv, pi, jv, ji.astype(np.int64), runs["dtype"] == "int8")


def test_step_chain_matches_jax_fused_topk(runs):
    for b in range(3):
        (pv, pi), (jv, ji) = runs["port"][b + 1], runs["jax_seq"][b]
        assert np.isfinite(pv).all()
        _assert_same_topk(pv, pi, jv, ji.astype(np.int64), runs["dtype"] == "int8")


def test_step_chain_equals_port_sequential_exactly(runs):
    for b in range(3):
        np.testing.assert_array_equal(runs["port"][b + 1][0], runs["port_seq"][b][0])
        np.testing.assert_array_equal(runs["port"][b + 1][1], runs["port_seq"][b][1])


def test_blockmax_scan_gather_plain_matches_jax(runs):
    """BM (the JAX step-major BM flattened to [Q, NB]) and the previous
    batch's raw scores (the JAX output trimmed of its KB padding to 8), on
    selections with -1 padding and the straddling block."""
    dtype, db, scales, qs = runs["dtype"], runs["db"], runs["scales"], runs["qs"]
    nb = N // 128
    rng = np.random.default_rng(5)
    bidx = rng.integers(0, nb, size=(Q, 7)).astype(np.int32)
    bidx[:, 2] = -1
    bidx[:, -1] = nb - 1
    with pltpu.force_tpu_interpret_mode():
        jbm, _, jprev = jps.blockmax_scan_gather(
            _jax(qs[0]), _jax(db), N_VALID, _jax(qs[1]), _jax(bidx), tile=TILE[dtype],
            scales=_jax(scales))
    jbm = np.asarray(jbm).transpose(1, 0, 2).reshape(Q, nb)
    jprev = np.asarray(jprev)[:, :bidx.shape[1] * 128]
    bm, prev = pipelined.blockmax_scan_gather_plain(
        _torch(qs[0]), _torch(db), N_VALID, _torch(qs[1]), torch.from_numpy(bidx),
        scales=_torch(scales))
    bm, prev = bm.numpy(), prev.numpy()
    assert (prev[:, 2 * 128:3 * 128] == NEG_CAP).all()
    assert (prev[:, -128 + N_VALID % 128:] == NEG_CAP).all()     # rows past n_valid
    for got, want in ((bm, jbm), (prev, jprev)):
        assert got.shape == want.shape
        masked = want <= NEG_CAP
        np.testing.assert_array_equal(got <= NEG_CAP, masked)
        if dtype == "int8":
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want)[~masked] <= _tol(want)[~masked]).all()


@pytest.mark.parametrize("selection", ["hot", "all_padding", "repeated"])
def test_blockmax_scan_gather_plain_on_edge_selections_matches_jax(runs, selection):
    """The selections the card's block-major pass treats apart: every
    previous query selecting the same blocks (hot blocks), nothing but
    padding, and one block in several columns of each row."""
    dtype, db, scales, qs = runs["dtype"], runs["db"], runs["scales"], runs["qs"]
    nb = N // 128
    rng = np.random.default_rng(6)
    if selection == "hot":
        bidx = np.repeat(rng.integers(0, nb, size=(1, 7)), Q, axis=0)
    elif selection == "all_padding":
        bidx = np.full((Q, 7), -1)
    else:
        bidx = rng.integers(0, nb, size=(Q, 7))
        bidx[:, 1:4] = bidx[:, :1]
    bidx = bidx.astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        _, _, jprev = jps.blockmax_scan_gather(
            _jax(qs[0]), _jax(db), N_VALID, _jax(qs[1]), _jax(bidx), tile=TILE[dtype],
            scales=_jax(scales))
    jprev = np.asarray(jprev)[:, :bidx.shape[1] * 128]
    _, prev = pipelined.blockmax_scan_gather(
        _torch(qs[0]), _torch(db), N_VALID, _torch(qs[1]), torch.from_numpy(bidx),
        scales=_torch(scales))
    prev = prev.numpy()
    masked = jprev <= NEG_CAP
    np.testing.assert_array_equal(prev <= NEG_CAP, masked)
    assert masked.all() == (selection == "all_padding")
    if dtype == "int8":
        np.testing.assert_array_equal(prev, jprev)
    else:
        assert (np.abs(prev - jprev)[~masked] <= _tol(jprev)[~masked]).all()
    if selection == "repeated":
        p3 = prev.reshape(Q, 7, 128)
        assert (p3[:, 1:4] == p3[:, :1]).all()


def test_blockmax_scan_gather_wrapper_is_the_plain_version_on_cpu(runs):
    db, scales, qs = _torch(runs["db"]), _torch(runs["scales"]), runs["qs"]
    bidx = torch.tensor([[0, -1, 5]] * Q, dtype=torch.int32)
    n0 = pipelined.launches
    got = pipelined.blockmax_scan_gather(_torch(qs[0]), db, N_VALID, _torch(qs[1]), bidx,
                                         scales)
    want = pipelined.blockmax_scan_gather_plain(_torch(qs[0]), db, N_VALID,
                                                _torch(qs[1]), bidx, scales)
    assert pipelined.launches == n0          # plain runs are not launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_blockmax_scan_gather_scales_the_previous_batch():
    """pv_scale_sel multiplies the previous batch's raw int8 scores by their
    block's scale, and leaves the NEG_CAP sentinels as they are."""
    db, scales, qs = _make("int8")
    db, scales = _torch(db), _torch(scales)
    bidx = torch.tensor([[0, -1, 5]] * Q, dtype=torch.int32)
    ss = selected_scales(scales, bidx)
    args = (_torch(qs[0]), db, N_VALID, _torch(qs[1]), bidx, scales)
    bm_raw, raw = pipelined.blockmax_scan_gather(*args)
    bm, got = pipelined.blockmax_scan_gather(*args, pv_scale_sel=ss)
    assert torch.equal(bm, bm_raw)
    raw3, ss3 = raw.view(Q, 3, 128), ss[:, :, None].expand(Q, 3, 128)
    sentinel = raw3 <= NEG_CAP
    assert sentinel[:, 1].all() and not sentinel[:, 0].any()
    want = torch.where(sentinel, raw3, raw3 * ss3).view(raw.shape)
    assert torch.equal(got, want)


def test_fused_topk_step_rejects_bad_inputs():
    db = torch.zeros(1024, 128, dtype=torch.bfloat16)
    q = torch.zeros(4, 128, dtype=torch.bfloat16)
    _, carry = pipelined.fused_topk_step(q, db, 1000, 3, None)
    with pytest.raises(ValueError):           # the batch size must stay constant
        pipelined.fused_topk_step(q[:2], db, 1000, 3, carry)
    with pytest.raises(ValueError):           # int8 needs scales
        pipelined.blockmax_scan_gather(q.to(torch.int8), db.to(torch.int8), 1000,
                                       q.to(torch.int8), carry["bidx"])
    with pytest.raises(TypeError):
        pipelined.blockmax_scan_gather(q, db, 1000, q.float(), carry["bidx"])
    with pytest.raises(ValueError):
        pipelined.blockmax_scan_gather(q, db[:1000], 1000, q, carry["bidx"])
    with pytest.raises(ValueError):           # previous-batch scales are int8's
        pipelined.blockmax_scan_gather(q, db, 1000, q, carry["bidx"],
                                       pv_scale_sel=torch.ones(carry["bidx"].shape))


def test_perf_pipelined_main_runs_on_cpu(capsys):
    out = perf_pipelined.main(["--device", "cpu", "--log2-rows", "13", "--q", "16",
                               "--k", "5", "--repeats", "2"])
    assert [(r["dtype"], r["q"]) for r in out["runs"]] == [("bf16", 16), ("int8", 16)]
    assert all(r["exact"] and r["primer"] for r in out["runs"])
    assert "pipelined == sequential" in capsys.readouterr().out
