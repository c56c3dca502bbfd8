"""The cover invariant of the fused scan, and phase A's launch geometry.

The fused scan is exact because phase A's block max is the maximum of the
very floats phase C computes for that block's rows (ops/fused_scan.py).
Here the plain versions, which the CPU runs, are held to that invariant:
phase B's selection from `blockmax_plain`'s BM, rescored by `gather_plain`,
must give back BM exactly for every selected block wholly below n_valid
(`cover_check`). Both plain versions round one float64 score to float32, so
the invariant is exact; the card's kernels are held to it in
tests/test_torch_kernels_gpu.py. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import blockmax, gather, topk
from merizo_search_tpu_torch.ops.fused_scan import cover_check, select_blocks, selected_scales


def _problem(dtype, nq, n=3000, seed=21):
    """Unit rows, n_valid = n ending mid-block (3000 = 23 * 128 + 56), and
    a length channel that masks about half the rows of each query."""
    rng = np.random.default_rng(seed)
    npad = -(-n // 128) * 128
    db = np.zeros((npad, 128), np.float32)
    db[:n] = rng.normal(size=(n, 128))
    db[:n] /= np.linalg.norm(db[:n], axis=1, keepdims=True)
    q = rng.normal(size=(nq, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tl = np.full(npad, 1e9, np.float32)
    tl[:n] = rng.uniform(50, 300, n).astype(np.float32) * np.float32(0.7)
    qcap = rng.uniform(50, 300, nq).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    if dtype == "int8":
        db8, sc = topk.quantize_blocks(db)
        q8, _ = topk.quantize_rows(q)
        return n, t(q8), t(db8), t(sc), t(tl), t(qcap)
    return n, t(q).to(torch.bfloat16), t(db).to(torch.bfloat16), None, t(tl), t(qcap)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("nq", [1, 7, 33])
def test_cover_invariant_on_plain_versions(dtype, use_len, nq):
    n, q, db, sc, tl, qcap = _problem(dtype, nq)
    lk = (tl, qcap) if use_len else (None, None)
    bm = blockmax.blockmax_plain(q, db, n, *lk, sc)
    bidx = select_blocks(bm, n, 10)
    assert int(bidx[:, -1].min()) == n // 128          # the straddling block is in
    kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
    scores = gather.gather_plain(q, db, bidx, n, *lk, **kw)
    compared, differ = cover_check(bm, scores, bidx, n)
    assert compared >= nq * 10 and differ == 0


def test_cover_check_counts_a_broken_cover():
    """One compared block of one query whose phase-C scores all sit one
    float above the ones phase A saw: exactly that column differs."""
    n, q, db, sc, tl, qcap = _problem("bf16", 7)
    bm = blockmax.blockmax_plain(q, db, n, tl, qcap)
    bidx = select_blocks(bm, n, 10)
    scores = gather.gather_plain(q, db, bidx, n, tl, qcap)
    compared, differ = cover_check(bm, scores, bidx, n)
    assert differ == 0
    kept = scores[3, :128] > -3.0e38                   # column 0: query 3's best block
    assert int(bidx[3, 0]) >= 0 and kept.any()
    scores[3, :128] = torch.where(kept, torch.nextafter(scores[3, :128],
                                                        torch.tensor(2.0)), scores[3, :128])
    assert cover_check(bm, scores, bidx, n) == (compared, 1)


@pytest.mark.parametrize("nq, qgroups", [(1, 1), (7, 1), (32, 1), (33, 2), (64, 2),
                                         (65, 4), (128, 4), (129, 8), (256, 8), (300, 8)])
def test_query_groups(nq, qgroups):
    assert blockmax.query_groups(nq) == qgroups


@pytest.mark.parametrize("nq, nb, sms, ctas, want", [
    (32, 3907, 132, 2, (1, 15)),          # the search path's shape: 261 CTAs
    (256, 131072, 132, 2, (8, 497)),      # 2^24 rows, Q 256: one CTA per slot
    (256, 131072, 132, 3, (8, 331)),
    (300, 131072, 132, 2, (8, 993)),      # two query tiles share the grid
    (7, 157, 132, 3, (1, 1)),             # fewer blocks than slots
    (5000, 100, 132, 2, (8, 8)),          # 20 query tiles, 13 chunks each
    (80000, 100, 132, 2, (8, 100)),       # more query tiles than slots
])
def test_phase_a_geometry(nq, nb, sms, ctas, want):
    qg, bpc = blockmax.phase_a_geometry(nq, nb, sms, ctas)
    assert (qg, bpc) == want
    qtiles = -(-nq // (32 * qg))
    chunks = -(-nb // bpc)
    assert chunks * bpc >= nb > (chunks - 1) * bpc       # every block, once
    assert qtiles * chunks <= max(sms * ctas, qtiles)    # a grid resident at once
