"""Phase B's selection (ops/select.py) on the CPU.

`phase_b_plain` repeats the select kernel's decomposition (slices of BM,
then merges of their candidates, then one sorted slice a query; whole rows
sorted where K is above SORT_K) and its order (an order-preserving uint32
key of the float bits, ties by lower block id). Here it is held against an
oracle that needs neither: a stable descending sort of each row's keys.
The kernel itself is held to `phase_b_plain` bit for bit on the card
(tests/test_torch_select_gpu.py). Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import blockmax, gather, select, topk
from merizo_search_tpu_torch.ops.fused_scan import (final_topk, fused_topk, select_blocks,
                                                    selected_scales)
from merizo_search_tpu_torch.utils import profiling

NEG_CAP = np.float32(-3.4e38)


def _bm(nq, nb, pattern, seed=0):
    """float32 [nq, nb]: normal floats; `ties` a handful of values, so runs
    of ties cross every slice edge; `zeros` half +0.0 / -0.0; `negcap` the
    second half of each row and the first two rows NEG_CAP."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nq, nb)).astype(np.float32)
    if pattern == "ties":
        x = np.round(x * 2) / 2
    elif pattern == "zeros":
        z = rng.random((nq, nb)) < 0.5
        x[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif pattern == "negcap":
        x[:, nb // 2:] = NEG_CAP
        x[:2] = NEG_CAP
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _oracle(bm, n_valid, k):
    """bidx by a stable descending sort of the float keys: value order,
    lower id first among equal keys, -0.0 below +0.0."""
    nq, nb = bm.shape
    bits = bm.view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    top = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :min(k + 1, nb)]
    straddle = min(n_valid // 128, nb - 1)
    top = torch.where(top == straddle, -1, top)
    return torch.cat([top, top.new_full((nq, 1), straddle)], dim=1).to(torch.int32)


SHAPES = [       # (Q, NB, k)
    (1, 1, 5),            # NB = 1
    (4, 60, 100),         # NB < KB: every block
    (1, 3_907, 10),       # CATH: one slice
    (32, 3_907, 100),
    (256, 3_907, 1),
    (256, 20_483, 10),    # two slices, the last ragged, then a merge
    (8, 20_483, 1_000),   # K above the prefilter's reach
    (2, 190_000, 1_000),  # 10 slices x 1,001 candidates: a second merge level
    (2, 20_000, 3_000),   # K above SORT_K: whole rows sorted
]


@pytest.mark.parametrize("pattern", ["random", "ties", "zeros", "negcap"])
@pytest.mark.parametrize("nq, nb, k", SHAPES)
def test_plain_matches_stable_sort_oracle(nq, nb, k, pattern):
    bm = _bm(nq, nb, pattern)
    n_valid = (nb // 2) * 128 + 17
    bidx, ss = select.phase_b_plain(bm, n_valid, k)
    assert ss is None and bidx.dtype == torch.int32
    assert torch.equal(bidx, _oracle(bm, n_valid, k))


@pytest.mark.parametrize("k", [1, 10, 39, 45, 400])
@pytest.mark.parametrize("pattern", ["random", "ties"])
def test_small_slices_decompose_exactly(monkeypatch, k, pattern):
    """With slices of 50 BM entries and merges of 120 candidates, a row of
    1,000 blocks takes two to four levels (or the sort path, K above 40):
    the same result as the oracle."""
    monkeypatch.setattr(select, "WMAX", 50)
    monkeypatch.setattr(select, "PCAP", 120)
    monkeypatch.setattr(select, "SORT_K", 40)
    bm = _bm(5, 1_000, pattern, seed=k)
    levels = select.plan(1_000, k)[1]
    assert levels is None if k + 1 > 40 else len(levels) >= (2 if k == 1 else 3)
    assert torch.equal(select.phase_b_plain(bm, 77_777, k)[0], _oracle(bm, 77_777, k))


@pytest.mark.parametrize("where", ["first", "middle", "last", "selected"])
@pytest.mark.parametrize("nq, nb, k", [(33, 20_483, 100), (7, 3_907, 10), (2, 20_000, 3_000)])
def test_straddling_block(nq, nb, k, where):
    """Column K holds the block that straddles n_valid, wherever it lies;
    where the top columns already hold it, it is -1 there."""
    bm = _bm(nq, nb, "random", seed=3)
    n_valid = {"first": 5, "middle": (nb // 2) * 128 + 3, "last": nb * 128 + 999,
               "selected": (nb // 3) * 128 + 64}[where]
    straddle = min(n_valid // 128, nb - 1)
    if where == "selected":
        bm[:, straddle] = 50.0
    bidx = select.phase_b_plain(bm, n_valid, k)[0]
    assert torch.equal(bidx, _oracle(bm, n_valid, k))
    assert torch.all(bidx[:, -1] == straddle)
    assert torch.all((bidx[:, :-1] == straddle).sum(dim=1) == 0)
    if where == "selected":
        assert torch.all(bidx[:, 0] == -1)


def test_key_order_of_special_floats():
    """The composite orders floats as their values, -0.0 below +0.0,
    NEG_CAP and -inf below every finite value, denormals in place."""
    vals = np.array([np.inf, 3.0, 1e-40, 0.0, -0.0, -1e-40, -2.0, NEG_CAP, -np.inf],
                    np.float32)
    perm = np.random.default_rng(1).permutation(len(vals))
    bm = torch.from_numpy(vals[perm][None, :].copy())
    bidx = select.phase_b_plain(bm, 10 ** 9, len(vals))[0]
    assert [int(perm[i]) for i in bidx[0, :len(vals)]] == list(range(len(vals)))


@pytest.mark.parametrize("nb, k", [(356_441, 100), (3_907, 100), (3_907, 10), (1, 0),
                                   (10_241, 2_047), (10 ** 6, 100), (20_000, 3_000),
                                   (500_000, 2_047)])
def test_plan_covers_every_entry(nb, k):
    """Every level's slices cover its input with no empty slice, each level
    reads what the one before wrote (slices x K), the last has one slice a
    query, and BM slices fit WMAX; TED's shard takes two launches, CATH one."""
    kk, levels = select.plan(nb, k)
    assert kk == min(k + 1, nb)
    if levels is None:
        assert kk > select.SORT_K and select.launches(nb, k) == select.sort_launches(nb)
        return
    n = nb
    for i, (pairs, n_in, width, slices) in enumerate(levels):
        assert pairs == (i > 0) and n_in == n
        assert (slices - 1) * width < n <= slices * width
        assert width <= (select.PCAP if pairs else select.WMAX)
        n = slices * kk
    assert levels[-1][3] == 1
    assert select.launches(nb, k) == {356_441: 2, 3_907: 1}.get(nb, len(levels))


@pytest.mark.parametrize("nb", [2_049, 4_096, 4_097, 20_000, 356_441])
def test_sort_launches_count_the_launchers_loops(nb):
    """sort_launches against csrc/select.cu mst_select_sort's loops."""
    p = 1 << (nb - 1).bit_length()
    t = min(p, select.SORT_TILE)
    n, size = 1, 2 * t
    while size <= p:
        stride = size // 2
        while stride >= t:
            n, stride = n + 1, stride // 2
        n, size = n + 1, size * 2
    assert select.sort_launches(nb) == n + 1


def test_scales_follow_the_selection():
    """scale_sel: each selected block's scale from the per-row scales, 1.0
    where bidx is -1; the same as selected_scales of the selection."""
    nb = 3_907
    bm = _bm(9, nb, "random", seed=4)
    scales = torch.from_numpy(np.random.default_rng(4).random(nb, np.float32))
    scales = scales.repeat_interleave(128)
    n_valid = 1_000 * 128 + 1
    bm[:, 1_000] = 9.0                      # the straddling block selected: a -1 column
    bidx, ss = select.phase_b_plain(bm, n_valid, 10, scales)
    assert torch.equal(bidx, select_blocks(bm, n_valid, 10))
    assert torch.equal(ss, selected_scales(scales, bidx))
    want = torch.where(bidx >= 0, scales[bidx.clamp(min=0).long() * 128], 1.0)
    assert torch.equal(ss, want) and bool((ss[bidx < 0] == 1.0).all())


def test_empty_inputs_and_bad_arguments():
    bidx, ss = select.phase_b(torch.zeros((0, 5)), 100, 10, torch.ones(640))
    assert bidx.shape == (0, 6) and ss.shape == (0, 6)
    bidx, _ = select.phase_b(torch.zeros((3, 0)), 100, 10)
    assert bidx.tolist() == [[-1]] * 3
    with pytest.raises(TypeError):
        select.phase_b(torch.zeros((2, 5), dtype=torch.float64), 100, 3)
    with pytest.raises(ValueError):
        select.phase_b(torch.zeros((2, 5)), 100, 3, torch.ones(5))


def test_cpu_tensors_launch_nothing():
    before = profiling.counter(select.LAUNCHES)
    bidx, _ = select.phase_b(_bm(4, 20_483, "random"), 10 ** 6, 100, torch.ones(20_483 * 128))
    selected_scales(torch.ones(20_483 * 128), bidx)
    assert profiling.counter(select.LAUNCHES) == before


def _topk_select(bm, n_valid, k):
    """Phase B as the port selected before its kernel: torch.topk over BM."""
    qn, nb = bm.shape
    straddle = min(n_valid // 128, nb - 1)
    top = torch.topk(bm, min(k + 1, nb), dim=1).indices
    top = torch.where(top == straddle, -1, top)
    return torch.cat([top, top.new_full((qn, 1), straddle)], dim=1).to(torch.int32)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_topk_returns_what_topk_selection_returned(dtype, k):
    """On distinct block maxima the selection is torch.topk's set in its
    order, so fused_topk returns the same scores and ids as phases A and C
    around a torch.topk selection."""
    rng = np.random.default_rng(k)
    n = 40_000 + 37
    db = rng.normal(size=(-(-n // 128) * 128, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = rng.normal(size=(12, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sc = None
    if dtype == "int8":
        db, sc = topk.quantize_blocks(db)
        q, _ = topk.quantize_rows(q)
        sc = torch.from_numpy(sc)
    qt, dbt = torch.from_numpy(q), torch.from_numpy(db)
    if dtype == "bf16":
        qt, dbt = qt.to(torch.bfloat16), dbt.to(torch.bfloat16)
    v, i = fused_topk(qt, dbt, n, k, scales=sc)
    bm = blockmax.blockmax_plain(qt, dbt, n, scales=sc)
    old = _topk_select(bm, n, k)
    assert torch.equal(select_blocks(bm, n, k), old)
    kw = {} if sc is None else {"scale_sel": select.scales_plain(sc, old)}
    wv, wi = final_topk(gather.gather_plain(qt, dbt, old, n, **kw), old, k)
    assert torch.equal(v, wv) and torch.equal(i, wi)


def test_perf_scan_select_rows_on_cpu():
    """tools/perf_scan's select rows at small shapes on the CPU: the check
    against the plain version passes, and each row carries its launches and
    byte bound (host times there, not device metrics)."""
    from merizo_search_tpu_torch.tools import perf_scan

    dev = torch.device("cpu")
    rows = perf_scan.select_rows(1, None, dev, torch.Generator().manual_seed(0),
                                 shapes=((4, 3_907, 10), (2, 20_483, 100)))
    assert [(r["launches"], r["exact"]) for r in rows] == [(1, True), (2, True)]
    assert rows[1]["bound_ms"] > rows[0]["bound_ms"] > 0 and rows[0]["bound_by"] == "bytes"
