"""The port's fused scan (phases A, B, C) against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages as
numpy. The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_scan.py does; the port runs on the CPU, where each kernel
wrapper takes its plain PyTorch version. Tolerances:
- scores in f32 / bf16: 1e-5 absolute. Both sides accumulate 128 products
  of unit-norm rows (the port in float64 rounded to float32, the JAX side in
  float32), so they differ by a few float32 ulps of values <= 1.
- int8: exact. Every partial sum is an integer below 2^24, and both sides
  dequantise with the same float32 multiply.
- top-k indices: equal, with runs of scores within 1e-5 of each other
  compared as sets (ties may come out in either order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from merizo_search_tpu.ops import pallas_scan as jps
from merizo_search_tpu.ops.topk import topk_scan as jax_topk_scan
from merizo_search_tpu_torch.ops import blockmax, gather, topk
from merizo_search_tpu_torch.ops.fused_scan import fused_topk

NEG_CAP = np.float32(-3.4e38)


def _unit(rng, n):
    x = rng.normal(size=(n, 128)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n, qn = 2048, 5
    db, q = _unit(rng, n), _unit(rng, qn)
    tlen = rng.uniform(50, 200, n).astype(np.float32)
    qlen = rng.uniform(50, 200, qn).astype(np.float32)
    tl = tlen * np.float32(0.7)
    db8, scales = topk.quantize_blocks(db)
    q8, _ = topk.quantize_rows(q)
    return dict(db=db, q=q, tl=tl, qlen=qlen, db8=db8, scales=scales, q8=q8)


def _inputs(data, dtype):
    """(q, db, scales) as numpy in the storage type: f32 / bf16 / int8."""
    if dtype == "int8":
        return data["q8"], data["db8"], data["scales"]
    if dtype == "bf16":
        to = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        return to(data["q"]), to(data["db"]), None
    return data["q"], data["db"], None


def _torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _compare_scores(got, want, exact):
    masked = want <= NEG_CAP
    np.testing.assert_array_equal(got <= NEG_CAP, masked)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got[~masked], want[~masked], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
def test_blockmax_matches_jax(data, dtype, use_len):
    q, db, scales = _inputs(data, dtype)
    n_valid = db.shape[0] - 77          # off a block edge: one straddling block
    tl, qcap = data["tl"], data["qlen"]
    want, _ = jps.blockmax_scan(jnp.asarray(q), jnp.asarray(db), n_valid,
                                jnp.asarray(tl), jnp.asarray(qcap), tile=512,
                                use_len=use_len, interpret=True,
                                scales=None if scales is None else jnp.asarray(scales))
    want = np.asarray(want).reshape(q.shape[0], -1)
    got = blockmax.blockmax_scan(
        _torch(q), _torch(db), n_valid,
        _torch(tl) if use_len else None, _torch(qcap) if use_len else None,
        _torch(scales)).numpy()
    assert got.shape == want.shape == (q.shape[0], db.shape[0] // 128)
    assert np.isfinite(got).all()
    _compare_scores(got, want, exact=dtype == "int8")


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
def test_gather_matches_jax(data, dtype, use_len):
    """Phase C against the JAX gather_block_scores (per-row scales for
    int8), on block ids that include -1 padding and the straddling block."""
    q, db, scales = _inputs(data, dtype)
    n_valid = db.shape[0] - 77
    nb = db.shape[0] // 128
    rng = np.random.default_rng(5)
    bidx = rng.integers(0, nb, size=(q.shape[0], 9)).astype(np.int32)
    bidx[:, 3] = -1
    bidx[:, -1] = nb - 1
    tl, qcap = data["tl"], data["qlen"]
    want = np.asarray(jps.gather_block_scores(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(tl.reshape(nb, 128)),
        jnp.asarray(qcap), jnp.asarray(bidx), n_valid, use_len=use_len,
        interpret=True, scales=None if scales is None else jnp.asarray(scales)))
    got = gather.gather_block_scores(
        _torch(q), _torch(db), torch.from_numpy(bidx), n_valid,
        _torch(tl) if use_len else None, _torch(qcap) if use_len else None,
        scales=_torch(scales)).numpy()
    assert got.shape == want.shape
    assert (got[:, 3 * 128:4 * 128] == NEG_CAP).all()
    _compare_scores(got, want, exact=dtype == "int8")


def test_gather_scale_modes_agree(data):
    """The production int8 mode (per-selected-block scale_sel) and the
    per-row mode give identical scores on block-uniform scales."""
    q8, db8, scales = _inputs(data, "int8")
    nb = db8.shape[0] // 128
    bidx = np.array([[0, 5, -1, nb - 1], [3, 3, 7, -1]], np.int32)
    sel = np.where(bidx >= 0, scales.reshape(nb, 128)[np.maximum(bidx, 0), 0], 1.0)
    args = (_torch(q8[:2]), _torch(db8), torch.from_numpy(bidx), db8.shape[0] - 77)
    per_row = gather.gather_block_scores(*args, scales=_torch(scales)).numpy()
    per_sel = gather.gather_block_scores(
        *args, scale_sel=torch.from_numpy(sel.astype(np.float32))).numpy()
    np.testing.assert_array_equal(per_sel, per_row)
    raw = gather.gather_block_scores(*args).numpy()
    ref = q8[:2].astype(np.int64) @ db8.astype(np.int64).T
    np.testing.assert_array_equal(raw[0, :128], ref[0, :128].astype(np.float32))


def _brute(q, db, n_valid, k, tlen=None, qlen=None, mincov=0.0):
    s = (q.astype(np.float64) @ db.astype(np.float64).T).astype(np.float32)
    s[:, n_valid:] = -np.inf
    if tlen is not None:
        s = np.where(qlen[:, None] >= tlen[None, :] * np.float32(mincov), s, -np.inf)
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, 1), idx


def _assert_same_topk(v1, i1, v2, i2, tol=1e-5):
    """Values agree to tol; indices agree position by position except inside
    runs of near-equal scores, which are compared as sets."""
    np.testing.assert_allclose(v1, v2, rtol=0, atol=tol)
    for r in range(v1.shape[0]):
        j = 0
        while j < v1.shape[1]:
            e = j + 1
            while e < v1.shape[1] and abs(v2[r, e] - v2[r, j]) <= tol:
                e += 1
            if e == v1.shape[1] and e - j > 1:   # a tie run at the cut: any subset
                assert len(set(i1[r, j:e])) == e - j
            else:
                assert set(i1[r, j:e]) == set(i2[r, j:e]), (r, j)
            j = e


@pytest.fixture(scope="module")
def big():
    """The shapes of tests/test_pallas_scan.py: N = 8192, 5 queries."""
    rng = np.random.default_rng(0)
    n = 1 << 13
    db, q = _unit(rng, n), _unit(rng, 5)
    db8, scales = topk.quantize_blocks(db)
    return dict(db=db, q=q, db8=db8, scales=scales, q8=topk.quantize_rows(q)[0],
                tlen=rng.uniform(50, 200, n).astype(np.float32),
                qlen=rng.uniform(50, 200, 5).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
def test_fused_topk_matches_jax_and_brute(big, dtype, use_len):
    k, mincov = 37, 0.7
    n_valid = big["db"].shape[0] - 77
    q, db, scales = _inputs(big, dtype)
    tlen, qlen = big["tlen"], big["qlen"]
    lkw = dict(tlen=jnp.asarray(tlen), qlen=jnp.asarray(qlen), mincov=mincov) if use_len else {}
    jv, ji = jps.fused_topk(jnp.asarray(q), jnp.asarray(db), n_valid, k, tile=2048,
                            use_len=use_len, interpret=True,
                            scales=None if scales is None else jnp.asarray(scales), **lkw)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tkw = dict(tlen=_torch(tlen), qlen=_torch(qlen), mincov=mincov) if use_len else {}
    tv, ti = fused_topk(_torch(q), _torch(db), n_valid, k, use_len=use_len,
                        scales=_torch(scales), **tkw)
    tv, ti = tv.numpy(), ti.numpy()
    _assert_same_topk(tv, ti, jv, ji)
    # brute force on the stored-precision values
    qf = np.asarray(jnp.asarray(q).astype(jnp.float32))
    dbf = np.asarray(jnp.asarray(db).astype(jnp.float32))
    if scales is not None:
        dbf = dbf * scales[:, None]
    bl = (tlen, qlen, mincov) if use_len else ()
    bv, bi = _brute(qf, dbf, n_valid, k, *bl)
    _assert_same_topk(tv, ti, bv, bi, tol=1e-5 if scales is None else 1e-4)


def test_fused_topk_few_valid_rows(big):
    """k larger than the number of valid rows: the tail is -inf / -1."""
    q, db = _torch(big["q"]), _torch(big["db"])
    v, i = fused_topk(q, db, 60, 100)
    v, i = v.numpy(), i.numpy()
    bv, bi = _brute(big["q"], big["db"], 60, 100)
    _assert_same_topk(v[:, :60], i[:, :60], bv[:, :60], bi[:, :60])
    assert (i[:, 60:] == -1).all() and (v[:, 60:] == -np.inf).all()


def test_fused_mincov_boundary_matches_plain_scan():
    """f32 coverage boundaries: qlen=9, tlen=30, mincov=0.3 keeps the hit in
    f32 (30*0.3f = 8.9999997); the fused scan must agree with the plain scan
    and with the JAX XLA scan exactly."""
    rng = np.random.default_rng(2)
    n, k = 512, 8
    db, q = _unit(rng, n), _unit(rng, 3)
    tlen, qlen = np.full(n, 30.0, np.float32), np.full(3, 9.0, np.float32)
    fv, fi = fused_topk(_torch(q), _torch(db), n, k, tlen=_torch(tlen),
                        qlen=_torch(qlen), mincov=0.3, use_len=True)
    pv, pi = topk.topk_scan(_torch(q), _torch(db), n, k, tlen=_torch(tlen),
                            qlen=_torch(qlen), mincov=0.3)
    xv, xi = jax_topk_scan(jnp.asarray(q), jnp.asarray(db), n, k, 256,
                           tlen=jnp.asarray(tlen), qlen=jnp.asarray(qlen), mincov=0.3)
    assert np.isfinite(fv.numpy()).all()
    np.testing.assert_array_equal(fi.numpy(), pi.numpy())
    np.testing.assert_array_equal(fi.numpy(), np.asarray(xi))


def test_topk_scan_matches_jax_chunked(big):
    """The plain scan across several chunks, with padding rows and mincov."""
    q, db = big["q"], big["db"]
    n_valid, k = db.shape[0] - 300, 25
    tv, ti = topk.topk_scan(_torch(q), _torch(db), n_valid, k, tlen=_torch(big["tlen"]),
                            qlen=_torch(big["qlen"]), mincov=0.7, chunk=3000)
    jv, ji = jax_topk_scan(jnp.asarray(q), jnp.asarray(db), n_valid, k, 2048,
                           tlen=jnp.asarray(big["tlen"]), qlen=jnp.asarray(big["qlen"]),
                           mincov=0.7)
    _assert_same_topk(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji))


def test_quantizers_match_jax(big):
    for fn in ("quantize_rows", "quantize_blocks"):
        mine, ref = getattr(topk, fn)(big["db"][:1000]), getattr(jps, fn)(big["db"][:1000])
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)


def test_kernel_wrappers_reject_bad_inputs():
    """Shape and dtype errors raise before any kernel or plain run."""
    q = torch.zeros(2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        blockmax.blockmax_scan(q, torch.zeros(100, 128, dtype=torch.bfloat16), 100)
    with pytest.raises(TypeError):
        blockmax.blockmax_scan(q, torch.zeros(128, 128, dtype=torch.int8), 128)
    with pytest.raises(ValueError):
        blockmax.blockmax_scan(q.to(torch.int8), torch.zeros(128, 128, dtype=torch.int8), 128)
    with pytest.raises(ValueError):
        gather.gather_block_scores(q, torch.zeros(128, 128, dtype=torch.bfloat16),
                                   torch.zeros(2, 1, dtype=torch.int32), 128,
                                   scale_sel=torch.ones(2, 1), scales=torch.ones(128))
