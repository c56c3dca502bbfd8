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
one order, XOR), their `full` scores as phase C's.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import (blockmax, gather, gather_variants, pipelined, probes,
                                         slab_interleave, topk)
from merizo_search_tpu_torch.ops.fused_scan import fused_topk, select_blocks, selected_scales

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["none", "reduce"])
@pytest.mark.parametrize("tile, nslab", [(1024, 2), (32768, 4)])
def test_mini_scan_kernel_matches_plain(cuda, data, dtype, mode, tile, nslab):
    q, db, _ = data[dtype]
    if tile > db.shape[0]:       # the fixed tile: two copies of the DB make a step
        db = torch.cat([db, db])[:tile]
    n0 = probes.launches["mini_scan"]
    got, sink = probes.mini_scan(*_on(cuda, q, db), tile, nslab, mode)
    torch.cuda.synchronize()
    assert probes.launches["mini_scan"] == n0 + 1
    want, wsink = probes.mini_scan(q, db, tile, nslab, mode)
    assert got.shape == want.shape
    got = got.cpu()
    if dtype == "int8":
        assert torch.equal(got, want) and sink.item() == wsink.item()
    else:
        assert (got - want).abs().max().item() <= 1e-5
        assert abs(sink.item() - wsink.item()) <= 1e-5


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
