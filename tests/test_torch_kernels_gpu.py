"""The CUDA kernels against their plain versions, on the card.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 scores 1e-5 absolute (unit-norm rows; the kernel sums 128
float32 products in order, the plain version in float64); int8 exact.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import blockmax, gather, topk
from merizo_search_tpu_torch.ops.fused_scan import fused_topk, select_blocks

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
