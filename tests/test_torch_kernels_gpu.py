"""The CUDA kernels against their plain versions, on the card.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 scores 1e-5 absolute (unit-norm rows; the kernel sums 128
float32 products in order, the plain version in float64); int8 exact; the
pipelined scan equals the sequential one on the card exactly (the same
device arithmetic); stream_probe exact (sums of small integers, XOR);
slab_scan equals blockmax_scan with the length channel off exactly (the
same dot routine); the gather variants' sums and sinks exact (f32 sums in
one order, XOR), their `full` scores as phase C's; the cover invariant
exact: phase C's max over a selected block's rows is phase A's BM for
that block, bit for bit (the two phases share one tensor-core routine).
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import (blockmax, gather, gather_variants, pipelined, probes,
                                         slab_interleave, topk)
from merizo_search_tpu_torch.ops.fused_scan import (cover_check, fused_topk, select_blocks,
                                                    selected_scales)

NEG_CAP = -3.4e38


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    n, qn = 20_000, 70                   # ragged: n % 128 != 0, Q % 64 != 0
    npad = -(-n // 128) * 128
    db = np.zeros((npad, 128), np.float32)
    db[:n] = rng.normal(size=(n, 128))
    db[:n] /= np.linalg.norm(db[:n], axis=1, keepdims=True)
    q = rng.normal(size=(qn, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tlen = np.full(npad, 1e9, np.float32)
    tlen[:n] = rng.integers(50, 400, n)
    db8, sc = topk.quantize_blocks(db)
    q8, _ = topk.quantize_rows(q)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return {"n": n, "tl": t(tlen * np.float32(0.7)), "tlen": t(tlen),
            "qlen": t(rng.integers(50, 400, qn).astype(np.float32)),
            "bf16": (t(q).to(torch.bfloat16), t(db).to(torch.bfloat16), None),
            "int8": (t(q8), t(db8), t(sc))}


def _compare(got, want, exact):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got <= NEG_CAP, want <= NEG_CAP)
    keep = want > NEG_CAP
    if exact:
        assert torch.equal(got, want)
    else:
        assert (got[keep] - want[keep]).abs().max().item() <= 1e-5


def _on(dev, *ts):
    return [None if t is None else t.to(dev) for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
def test_blockmax_kernel_matches_plain(cuda, data, dtype, use_len):
    q, db, sc = data[dtype]
    lk = (data["tl"], data["qlen"]) if use_len else (None, None)
    n0 = blockmax.launches
    got = blockmax.blockmax_scan(*_on(cuda, q, db), data["n"], *_on(cuda, *lk, sc))
    torch.cuda.synchronize()
    assert blockmax.launches == n0 + 1
    _compare(got, blockmax.blockmax_scan(q, db, data["n"], *lk, sc), dtype == "int8")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "int8_raw", "int8_scale_sel", "int8_row_scales"])
@pytest.mark.parametrize("use_len", [False, True])
def test_gather_kernel_matches_plain(cuda, data, mode, use_len):
    dtype = mode.split("_")[0]
    q, db, sc = data[dtype]
    lk = (data["tl"], data["qlen"]) if use_len else (None, None)
    nb = db.shape[0] // 128
    bidx = select_blocks(blockmax.blockmax_scan(q, db, data["n"], *lk, sc), data["n"], 9)
    bidx[::4, 2] = -1
    kw = {}
    if mode == "int8_scale_sel":
        kw["scale_sel"] = torch.where(bidx >= 0, sc.view(nb, 128)[bidx.clamp(min=0).long(), 0],
                                      1.0).contiguous()
    elif mode == "int8_row_scales":
        kw["scales"] = sc
    n0 = gather.launches
    got = gather.gather_block_scores(*_on(cuda, q, db, bidx), data["n"], *_on(cuda, *lk),
                                     **{k: v.to(cuda) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert gather.launches == n0 + 1
    _compare(got, gather.gather_block_scores(q, db, bidx, data["n"], *lk, **kw),
             dtype == "int8")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_fused_topk_on_card_matches_cpu(cuda, data, dtype):
    q, db, sc = data[dtype]
    kw = dict(tlen=data["tlen"], qlen=data["qlen"], mincov=0.7, use_len=True)
    gv, gi = fused_topk(*_on(cuda, q, db), data["n"], 50, scales=_on(cuda, sc)[0],
                        **{k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()})
    cv, ci = fused_topk(q, db, data["n"], 50, scales=sc, **kw)
    np.testing.assert_allclose(gv.cpu().numpy(), cv.numpy(), rtol=1e-5, atol=1e-5)
    for r in range(q.shape[0]):     # ties (within the tolerance) may swap
        assert len(set(gi[r].tolist()) ^ set(ci[r].tolist())) <= 2 * int(
            (np.abs(cv[r].numpy() - cv[r, -1].item()) <= 1e-5).sum())


@pytest.mark.gpu
def test_kernel_rejects_cpu_mixed_and_wrong_dtype(cuda, data):
    q, db, _ = data["bf16"]
    with pytest.raises(ValueError):
        blockmax.blockmax_scan(q.to(cuda), db, data["n"])
    with pytest.raises(TypeError):
        blockmax.blockmax_scan(q.float().to(cuda), db.float().to(cuda), data["n"])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_scale_sel"])
def test_bm_gather_kernel_matches_plain(cuda, data, mode):
    dtype = mode[:4]
    q, db, sc = data[dtype]
    bidx = select_blocks(blockmax.blockmax_scan(q, db, data["n"], scales=sc), data["n"], 9)
    bidx[::4, 2] = -1
    pv_q = q.flip(0).contiguous()
    ss = selected_scales(sc, bidx) if mode == "int8_scale_sel" else None
    n0 = pipelined.launches
    got = pipelined.blockmax_scan_gather(*_on(cuda, q, db), data["n"],
                                         *_on(cuda, pv_q, bidx, sc), pv_scale_sel=(
                                             None if ss is None else ss.to(cuda)))
    torch.cuda.synchronize()
    assert pipelined.launches == n0 + 1
    want = pipelined.blockmax_scan_gather(q, db, data["n"], pv_q, bidx, sc, ss)
    for g, w in zip(got, want):
        _compare(g, w, dtype == "int8")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_pipelined_equals_sequential_on_card(cuda, data, dtype):
    q, db, sc = _on(cuda, *data[dtype])
    batches = [q[:32].contiguous(), q[32:64].contiguous(), q[6:38].contiguous()]
    carry, outs = None, []
    for b in batches + batches[-1:]:
        res, carry = pipelined.fused_topk_step(b, db, data["n"], 50, carry, scales=sc)
        outs.append(res)
    assert (outs[0][0] == float("-inf")).all() and (outs[0][1] == -1).all()
    for b, (v, i) in zip(batches, outs[1:]):
        sv, si = fused_topk(b, db, data["n"], 50, scales=sc)
        assert torch.equal(v, sv) and torch.equal(i, si)


def _check_mini(got, sink, want, wsink, dtype):
    assert got.shape == want.shape
    got, want = got.cpu(), want.cpu()
    if dtype == "int8":
        assert torch.equal(got, want) and sink.item() == wsink.item()
    else:
        assert (got - want).abs().max().item() <= 1e-5
        assert abs(sink.item() - wsink.item()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["none", "reduce"])
@pytest.mark.parametrize("tile, nslab", [(1024, 2), (32768, 4)])
@pytest.mark.parametrize("nq", [70, 40, 300])
def test_mini_scan_kernel_matches_plain(cuda, data, dtype, mode, tile, nslab, nq):
    """Batches that are not multiples of 32 (query tiles of 128, 64 and 256
    with a ragged last one); the 300 queries repeat the data's 70."""
    q, db, _ = data[dtype]
    q = q.repeat(5, 1)[:nq].contiguous()
    if tile > db.shape[0]:       # the fixed tile: two copies of the DB make a step
        db = torch.cat([db, db])[:tile]
    n0 = probes.launches["mini_scan"]
    got, sink = probes.mini_scan(*_on(cuda, q, db), tile, nslab, mode)
    torch.cuda.synchronize()
    assert probes.launches["mini_scan"] == n0 + 1
    want, wsink = probes.mini_scan(q, db, tile, nslab, mode)
    _check_mini(got, sink, want, wsink, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["none", "reduce"])
def test_mini_scan_kernel_alone_launches_the_kernel(cuda, data, mode):
    """The timing helper launches the kernel and nothing that raises."""
    q, db, _ = _on(cuda, *data["bf16"][:2], None)
    run = probes.kernel_alone(q, db[:16384], 1024, 2, mode)
    n0 = probes.launches["mini_scan"]
    run()
    run()
    torch.cuda.synchronize()
    assert probes.launches["mini_scan"] == n0 + 2


def _steps_for_span(nq, span):
    """The fewest steps of tile 1024 (8 blocks) at which one of the card's
    mini_scan CTA ranges touches `span` steps."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nsteps in range(2, 4096):
        _, bpc, _ = probes.geometry(nq, nsteps, 8, sms)
        nb = nsteps * 8
        if max((min(nb, b0 + bpc) - 1) // 8 - b0 // 8 + 1 for b0 in range(0, nb, bpc)) >= span:
            return nsteps
    raise AssertionError(f"no DB size gives a range over {span} steps")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["none", "reduce"])
@pytest.mark.parametrize("nq, span", [(40, 2), (300, 2), (40, 3)])
def test_mini_scan_kernel_ranges_across_steps(cuda, data, dtype, mode, nq, span):
    """Tile 1024, nslab 2, with the DB sized so that CTA ranges touch `span`
    steps of 8 blocks (a range's "none" heads go to several steps); the
    plain version runs on the card (float64)."""
    q, db, _ = data[dtype]
    nsteps = _steps_for_span(nq, span)
    q = q.repeat(5, 1)[:nq].contiguous().to(cuda)
    db = db.to(cuda).repeat(-(-nsteps * 1024 // db.shape[0]), 1)[:nsteps * 1024].contiguous()
    got, sink = probes.mini_scan(q, db, 1024, 2, mode)
    torch.cuda.synchronize()
    want, wsink = probes.mini_scan_plain(q, db, 1024, 2, mode)
    _check_mini(got, sink, want, wsink, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("tile", [8, 1000, 2048])
def test_stream_probe_kernel_matches_plain(cuda, data, wide, tile):
    x = data["int8"][1]
    if wide:
        x = x.view(-1, 1024)
    n0 = probes.launches["stream_probe"]
    o, sink = probes.stream_probe(x.to(cuda), 2.0, tile)
    torch.cuda.synchronize()
    assert probes.launches["stream_probe"] == n0 + 1
    wo, wsink = probes.stream_probe(x, 2.0, tile)
    assert torch.equal(o.cpu(), wo) and sink.item() == wsink.item()


@pytest.mark.gpu
def test_new_kernels_reject_cpu_mixed_and_wrong_dtype(cuda, data):
    q, db, _ = data["bf16"]
    bidx = torch.zeros((q.shape[0], 3), dtype=torch.int32)
    with pytest.raises(ValueError):         # previous batch left on the CPU
        pipelined.blockmax_scan_gather(q.to(cuda), db.to(cuda), data["n"], q, bidx.to(cuda))
    with pytest.raises(TypeError):
        pipelined.blockmax_scan_gather(*_on(cuda, q.float(), db.float()), data["n"],
                                       *_on(cuda, q.float(), bidx))
    with pytest.raises(ValueError):
        probes.mini_scan(q.to(cuda), db, 1024)
    with pytest.raises(TypeError):
        probes.mini_scan(*_on(cuda, q.float(), db.float()), 1024)
    with pytest.raises(TypeError):
        probes.stream_probe(db.to(cuda), 0.0, 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nslab", [2, 8])
def test_slab_scan_kernel_matches_plain_and_blockmax(cuda, data, dtype, nslab):
    """The DB padded to 10 tiles of 2048 rows; n_valid = 20000 cuts block
    156 and floors the blocks after it. The BM-only build gives the same BM."""
    q, db, sc = data[dtype]
    pad = 10 * 2048 - db.shape[0]
    db = torch.cat([db, db.new_zeros((pad, 128))])
    sc = None if sc is None else torch.cat([sc, sc.new_ones(pad)])
    n0 = slab_interleave.launches
    bm, sbm = slab_interleave.slab_scan(*_on(cuda, q, db), data["n"], 2048, nslab,
                                        *_on(cuda, sc))
    torch.cuda.synchronize()
    assert slab_interleave.launches == n0 + 1
    want_bm, want_sbm = slab_interleave.slab_scan(q, db, data["n"], 2048, nslab, sc)
    _compare(bm, want_bm, dtype == "int8")
    _compare(sbm, want_sbm, dtype == "int8")
    assert (bm.cpu()[:, 157:] <= NEG_CAP).all() and (bm.cpu()[:, :157] > NEG_CAP).all()
    bm0 = blockmax.blockmax_scan(*_on(cuda, q, db), data["n"], scales=_on(cuda, sc)[0])
    assert torch.equal(bm, bm0)
    assert torch.equal(sbm, bm0.view(q.shape[0], 10, 16).amax(dim=2))
    bm_only, none = slab_interleave.slab_scan(*_on(cuda, q, db), data["n"], 2048, nslab,
                                              *_on(cuda, sc), sbm=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(bm_only, bm0)
    assert slab_interleave.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8_dma_only", "int8_concat_only", "int8_full",
                                  "int8_int32view", "bf16_dma_only", "bf16_concat_only",
                                  "bf16_full"])
def test_gather_variant_kernel_matches_plain(cuda, data, mode):
    dtype, kind = mode.split("_", 1)
    q, db, _ = data[dtype]
    rng = np.random.default_rng(5)
    bidx = torch.from_numpy(rng.integers(0, db.shape[0] // 128, (q.shape[0], 102))
                            .astype(np.int32))
    bidx[::5, 3] = -1                 # reads block 0
    bidx[1, 7] = bidx[1, 8]           # one block twice in a group
    n0 = gather_variants.launches[kind]
    got, sink = gather_variants.gather_variant(*_on(cuda, q, db, bidx), kind, 34)
    torch.cuda.synchronize()
    assert gather_variants.launches[kind] == n0 + 1
    want, wsink = gather_variants.gather_variant(q, db, bidx, kind, 34)
    assert got.shape == want.shape == (q.shape[0], 3, 34, 128)
    if dtype == "bf16" and kind == "full":
        assert (got.cpu() - want).abs().max().item() <= 1e-5
    else:
        assert torch.equal(got.cpu(), want)
    if kind == "full":
        assert sink is None and wsink is None
    else:
        assert sink.item() == wsink.item()


@pytest.mark.gpu
def test_third_slice_kernels_reject_cpu_mixed_and_wrong_dtype(cuda, data):
    q, db, sc = data["int8"]
    db = db[:16384]
    with pytest.raises(ValueError):
        slab_interleave.slab_scan(q.to(cuda), db, 16384, 2048, 2, sc[:16384].to(cuda))
    with pytest.raises(TypeError):
        slab_interleave.slab_scan(*_on(cuda, q.float(), db.float()), 16384, 2048, 2)
    bidx = torch.zeros((q.shape[0], 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_variants.gather_variant(*_on(cuda, q, db), bidx, "dma_only", 2)
    with pytest.raises(TypeError):
        gather_variants.gather_variant(*_on(cuda, *data["bf16"][:2], bidx), "int32view", 2)


@pytest.fixture(scope="module")
def odd():
    """Q = 300 unit queries (the tests take 1, 7, 33 or all 300 of them)
    and 20,000 unit rows: n_valid ends mid-block (156 * 128 + 32)."""
    rng = np.random.default_rng(9)
    n, qn = 20_000, 300
    npad = -(-n // 128) * 128
    db = np.zeros((npad, 128), np.float32)
    db[:n] = rng.normal(size=(n, 128))
    db[:n] /= np.linalg.norm(db[:n], axis=1, keepdims=True)
    q = rng.normal(size=(qn, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tl = np.full(npad, 1e9, np.float32)
    tl[:n] = rng.uniform(50, 400, n).astype(np.float32) * np.float32(0.7)
    db8, sc = topk.quantize_blocks(db)
    q8, _ = topk.quantize_rows(q)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return {"n": n, "tl": t(tl), "qlen": t(rng.uniform(50, 400, qn).astype(np.float32)),
            "bf16": (t(q).to(torch.bfloat16), t(db).to(torch.bfloat16), None),
            "int8": (t(q8), t(db8), t(sc))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("nq", [1, 7, 33, 300])
def test_cover_invariant_on_card(cuda, odd, dtype, use_len, nq):
    """Phase A's BM against its plain version (padded query columns never
    reach BM), then phase C on the blocks phase B picks from it: the max of
    a block's phase-C scores equals its BM exactly."""
    q, db, sc = _on(cuda, *odd[dtype])
    q = q[:nq].contiguous()
    n = odd["n"]
    lk = _on(cuda, odd["tl"], odd["qlen"][:nq].contiguous()) if use_len else (None, None)
    bm = blockmax.blockmax_scan(q, db, n, *lk, sc)
    torch.cuda.synchronize()
    _compare(bm, blockmax.blockmax_plain(q, db, n, *lk, sc), dtype == "int8")
    bidx = select_blocks(bm, n, 20)
    kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
    scores = gather.gather_block_scores(q, db, bidx, n, *lk, **kw)
    torch.cuda.synchronize()
    compared, differ = cover_check(bm, scores, bidx, n)
    assert compared >= nq * 20 and differ == 0


# Phase A's walk on Hopper (TMA ring, wgmma consumers) at its edges: every
# tile width the geometry picks (Q 1 and 7 -> N 32, 33 -> 64, 100 -> 128,
# 255 -> 256, 257 -> two tiles of 256, the second with one query), ragged
# n_valid, fewer blocks than CTAs and CTAs whose whole range lies past
# n_valid; each BM against the plain version and held to the cover
# invariant, bit for bit.
EDGE_Q = [1, 7, 33, 100, 255, 257]


def test_edge_batches_take_every_tile_width():
    assert {blockmax.tile_width(nq) for nq in EDGE_Q} == set(blockmax.TILE_WIDTHS)


def _bm_and_cover(q, db, sc, n, lk, k=20):
    bm = blockmax.blockmax_scan(q, db, n, *lk, sc)
    torch.cuda.synchronize()
    want = blockmax.blockmax_plain(q, db, n, *lk, sc)
    assert bool(torch.isfinite(bm).all())
    if n == 0:                  # every block past n_valid: NEG_CAP, nothing to compare
        assert torch.equal(bm.cpu(), want.cpu()) and bool((bm <= NEG_CAP).all())
        return bm
    _compare(bm, want, sc is not None)
    bidx = select_blocks(bm, n, k)
    kw = {} if sc is None else {"scale_sel": selected_scales(sc, bidx)}
    scores = gather.gather_block_scores(q, db, bidx, n, *lk, **kw)
    torch.cuda.synchronize()
    _compare(scores, gather.gather_plain(q, db, bidx, n, *lk, **kw), sc is not None)
    compared, differ = cover_check(bm, scores, bidx, n)
    assert compared > 0 and differ == 0
    return bm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("nq", EDGE_Q)
def test_walk_edges_at_every_tile_width(cuda, odd, dtype, use_len, nq):
    q, db, sc = _on(cuda, *odd[dtype])
    q = q[:nq].contiguous()
    lk = _on(cuda, odd["tl"], odd["qlen"][:nq].contiguous()) if use_len else (None, None)
    _bm_and_cover(q, db, sc, odd["n"], lk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n_valid", [6350, 300, 0])
@pytest.mark.parametrize("nq", [7, 257])
def test_walk_with_fewer_blocks_than_ctas(cuda, odd, dtype, n_valid, nq):
    """50 blocks against one CTA an SM: one block a CTA. n_valid 6,350 ends
    mid-block; at 300 all but three blocks, so the ranges of most CTAs, lie
    past it (NEG_CAP); at 0 every block does."""
    q, db, sc = _on(cuda, *odd[dtype])
    db, sc = db[:6400].contiguous(), None if sc is None else sc[:6400].contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert blockmax.phase_a_geometry(nq, 50, sms)[1] == 1
    _bm_and_cover(q[:nq].contiguous(), db, sc, n_valid, (None, None), k=3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nq", [7, 33, 100, 257])
def test_bm_gather_at_every_tile_width_equals_two_launches(cuda, odd, dtype, nq):
    """The pipelined kernel (both roles in one grid) against phase A then
    phase C launched alone, bit for bit, at each tile width."""
    q, db, sc = _on(cuda, *odd[dtype])
    q = q[:nq].contiguous()
    n = odd["n"]
    bidx = select_blocks(blockmax.blockmax_scan(q, db, n, scales=sc), n, 9)
    bidx[::4, 2] = -1
    pv_q = q.flip(0).contiguous()
    ss = None if sc is None else selected_scales(sc, bidx)
    bm, prev = pipelined.blockmax_scan_gather(q, db, n, pv_q, bidx, sc, ss)
    torch.cuda.synchronize()
    assert torch.equal(bm, blockmax.blockmax_scan(q, db, n, scales=sc))
    kw = {} if ss is None else {"scale_sel": ss}
    assert torch.equal(prev, gather.gather_block_scores(pv_q, db, bidx, n, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nq", [7, 33, 257])
def test_slab_scan_equals_blockmax_at_every_tile_width(cuda, data, dtype, nq):
    q, db, sc = data[dtype]
    q = q.repeat(4, 1)[:nq].contiguous()
    pad = 10 * 2048 - db.shape[0]
    db = torch.cat([db, db.new_zeros((pad, 128))])
    sc = None if sc is None else torch.cat([sc, sc.new_ones(pad)])
    q, db, sc = _on(cuda, q, db, sc)
    bm, sbm = slab_interleave.slab_scan(q, db, data["n"], 2048, 4, sc)
    bm0 = blockmax.blockmax_scan(q, db, data["n"], scales=sc)
    torch.cuda.synchronize()
    assert torch.equal(bm, bm0)
    assert torch.equal(sbm, bm0.view(nq, 10, 16).amax(dim=2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_built_layouts_fit_the_card(cuda, dtype):
    """The shared memory the built kernels ask for, read from the library
    (the constants their launchers use): phase A's at every tile width fits
    one CTA on this card, its slots and query tile on the 1024-byte swizzle
    period; six phase-C CTAs fit an SM."""
    props = torch.cuda.get_device_properties(cuda)
    per_cta = getattr(props, "shared_memory_per_block_optin", 232_448)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", 233_472)
    for n in blockmax.TILE_WIDTHS:
        lay = blockmax.walk_layout(dtype, n)
        assert lay["launch"] <= per_cta and lay["stages"] >= 4
        assert lay["slot_bytes"] % 1024 == 0 and lay["qt"] % 1024 == 0
        assert lay["qt"] == lay["stages"] * lay["slot_bytes"]
        assert lay["tl"] % 16 == 0 and lay["qcap"] % 16 == 0 and lay["bar"] % 8 == 0
    lay = gather.gather_layout(dtype)
    assert 6 * (lay["launch"] + 1024) <= per_sm and lay["bt"] % 1024 == 0


# The pipelined kernel as one pass over the DB (csrc/bm_gather.cu): the
# previous selection inverted block-major and scored on phase A's ring
# slots. Each case against phase A then phase C launched alone, bit for bit:
# every previous query selecting query 0's blocks (hot blocks listing Qp
# entries: Qp/16 passes at Qp 256), an all-padding selection, KB 0, Q 300
# (two query tiles walk each block; one scores its lists), the straddling
# block in a second column (rows past n_valid), one block three times in
# each row (residue lists longer than Qp/8), and int8 with and without the
# carried scales.
BMG_CASES = ["hot", "all_padding", "kb0", "two_tiles", "ragged", "repeated"]


def _bm_gather_selection(case, base):
    if case == "hot":
        return base[:1].expand(base.shape[0], -1).contiguous()
    if case == "all_padding":
        return torch.full_like(base, -1)
    if case == "kb0":
        return base[:, :0].contiguous()
    bidx = base.clone()
    if case == "ragged":
        bidx[:, 1] = base[:, -1]
    elif case == "repeated":
        bidx[:, 1:4] = bidx[:, :1]
    return bidx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, with_ss", [("bf16", False), ("int8", True), ("int8", False)])
@pytest.mark.parametrize("case", BMG_CASES)
def test_bm_gather_selections_equal_two_launches(cuda, odd, dtype, with_ss, case):
    q, db, sc = _on(cuda, *odd[dtype])
    n = odd["n"]
    nq = {"hot": 256, "two_tiles": 300}.get(case, 64)
    cur, pv_q = q[:nq].contiguous(), q.flip(0)[:nq].contiguous()
    base = select_blocks(blockmax.blockmax_scan(pv_q, db, n, scales=sc), n, 9)
    bidx = _bm_gather_selection(case, base)
    ss = selected_scales(sc, bidx) if with_ss else None
    n0, i0 = pipelined.launches, pipelined.inversions
    bm, prev = pipelined.blockmax_scan_gather(cur, db, n, pv_q, bidx, sc, ss)
    torch.cuda.synchronize()
    assert pipelined.launches == n0 + 1
    assert pipelined.inversions == i0 + (bidx.numel() > 0)
    assert torch.equal(bm, blockmax.blockmax_scan(cur, db, n, scales=sc))
    kw = {} if ss is None else {"scale_sel": ss}
    want = gather.gather_block_scores(pv_q, db, bidx, n, **kw)
    assert prev.shape == want.shape and torch.equal(prev, want)
    if case == "all_padding":
        assert bool((prev <= NEG_CAP).all())
    if case == "ragged":   # the straddling block's rows past n_valid are NEG_CAP
        cols = prev.view(nq, -1, 128)[:, 1]
        assert bool((cols[:, n % 128:] <= NEG_CAP).all()) and bool((cols[:, :n % 128] > NEG_CAP).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_bm_gather_with_no_current_batch(cuda, odd, dtype):
    """Q = 0 (the drain of a pipeline with nothing new): the walk still
    scores the previous selection."""
    q, db, sc = _on(cuda, *odd[dtype])
    n = odd["n"]
    pv_q = q[:40].contiguous()
    bidx = select_blocks(blockmax.blockmax_scan(pv_q, db, n, scales=sc), n, 5)
    bm, prev = pipelined.blockmax_scan_gather(q[:0], db, n, pv_q, bidx, sc)
    torch.cuda.synchronize()
    assert bm.shape == (0, db.shape[0] // 128)
    assert torch.equal(prev, gather.gather_block_scores(pv_q, db, bidx, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_bm_gather_layout_fits_the_card(cuda, dtype):
    """The pipelined kernel's shared memory as built (csrc/bm_gather.cu
    BmGatherSmem, read from the library): phase A's layout first, the B
    tiles on the swizzle period, one CTA at every tile width."""
    props = torch.cuda.get_device_properties(cuda)
    per_cta = getattr(props, "shared_memory_per_block_optin", 232_448)
    for n in blockmax.TILE_WIDTHS:
        lay, walk = pipelined.bm_gather_layout(dtype, n), blockmax.walk_layout(dtype, n)
        assert walk["bytes"] <= lay["bt"] and lay["bt"] % 1024 == 0
        assert lay["win"] % 16 == 0 and lay["launch"] <= per_cta
