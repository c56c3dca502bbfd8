"""The IVF index on the card: phase C's f32 mode (the rerank) against its
plain version; the block-major launch that the IVF runs
(`gather_block_scores_by_block`) against the per-query kernel
(`gather_block_scores`) bit for bit, in every dtype and scale mode, with
and without the length mask, on adversarial lists (every query in one
residue class mod 8, one block probed by every query, Q = 1), and its
inversion against `invert_plain`; and ivf_search on the card against the
same call on the CPU (which runs the kernels' plain versions).

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_ivf_gpu.py

Tolerances: f32 and bf16 scores 1e-5 absolute (unit-norm rows; the kernel
sums 128 products in order in float32, the plain version in float64);
int8 exact before the per-query rescale. ivf_search's ids on the card and
on the CPU are equal except among scores within 1e-5 of the k-th.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.ops import blockmax, gather, topk
from merizo_search_tpu_torch.ops.fused_scan import selected_scales
from merizo_search_tpu_torch.search import ivf
from merizo_search_tpu_torch.utils.profiling import counter

NEG_CAP = -3.4e38
NLIST, K = 32, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mixture():
    rng = np.random.default_rng(12)
    n = 1 << 13
    centers = rng.normal(size=(16, 128)).astype(np.float32) * 3
    emb = centers[rng.integers(0, 16, n)] + rng.normal(size=(n, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.choice(n, 40, replace=False)] + rng.normal(size=(40, 128)).astype(np.float32) * .03
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    lengths = rng.integers(50, 300, n).astype(np.float32)
    return emb, q.astype(np.float32), lengths


@pytest.fixture(scope="module")
def layout(mixture):
    return ivf.build_ivf(mixture[0], NLIST, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("scale", ["none", "scale_sel"])
def test_f32_gather_matches_plain(cuda, mixture, use_len, scale):
    emb, q, lengths = mixture
    rng = np.random.default_rng(5)
    n = len(emb) - 77                                     # rows past n_valid are masked
    nb = len(emb) // 128
    bidx = torch.from_numpy(rng.integers(-1, nb, (len(q), 101)).astype(np.int32))
    args = [torch.from_numpy(q), torch.from_numpy(emb), bidx, n]
    kw = {}
    if use_len:
        kw.update(tl=torch.from_numpy(lengths * np.float32(0.7)),
                  qcap=torch.from_numpy(rng.integers(50, 300, len(q)).astype(np.float32)))
    if scale == "scale_sel":
        kw["scale_sel"] = torch.from_numpy(rng.uniform(0.5, 2, bidx.shape).astype(np.float32))
    want = gather.gather_plain(*args, **kw)
    n0 = counter(gather.LAUNCHES)
    got = gather.gather_block_scores(*[a.to(cuda) if torch.is_tensor(a) else a for a in args],
                                     **{k: v.to(cuda) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert counter(gather.LAUNCHES) == n0 + 1
    got = got.cpu()
    assert torch.equal(got <= NEG_CAP, want <= NEG_CAP)
    keep = want > NEG_CAP
    tol = 1e-5 * (2.0 if scale == "scale_sel" else 1.0)      # scales up to 2
    assert (got[keep] - want[keep]).abs().max().item() <= tol


def _operands(emb, q, lay, dtype, dev):
    f32 = ivf.permute_db(emb, lay)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    out = {"cent": t(lay["centroids"]), "perm": t(lay["perm"]), "hi": t(f32), "qf": t(q)}
    if dtype == "int8":
        d8, sc = topk.quantize_blocks(f32)
        q8, _ = topk.quantize_rows(q)
        out.update(db=t(d8), scales=t(sc), q8=t(q8), q=t(q))
    else:
        out.update(db=t(f32).to(torch.bfloat16), scales=None, q8=None,
                   q=t(q).to(torch.bfloat16))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("mincov", [0.0, 0.7])
def test_ivf_search_on_the_card_matches_the_cpu(cuda, mixture, layout, dtype, rerank, mincov):
    emb, q, lengths = mixture
    perm = layout["perm"]
    lp = np.full(len(perm), 1e9, np.float32)
    lp[perm >= 0] = lengths[perm[perm >= 0]]
    res = {}
    for dev in ("cpu", cuda):
        o = _operands(emb, q, layout, dtype, dev)
        kw = {"scales": o["scales"], "q8": o["q8"], "dedup": layout["dup"]}
        if rerank:
            kw.update(rerank_hi=o["hi"], q_hi=o["qf"])
        if mincov:
            kw.update(tlen=torch.from_numpy(lp).to(dev), mincov=mincov, use_len=True,
                      qlen=torch.full((len(q),), 150.0, device=dev))
        names = (gather.LAUNCHES, gather.LAUNCHES_BY_BLOCK, gather.LAUNCHES_BY_BLOCK_F32)
        n0 = [counter(n) for n in names]
        v, i = ivf.ivf_search(o["q"], o["db"], o["cent"], o["perm"], K, 8, **kw)
        if dev != "cpu":
            assert [counter(n) for n in names] \
                == [n0[0], n0[1] + (2 if rerank else 1), n0[2] + rerank]
        res[str(dev)] = (v.cpu().numpy(), i.cpu().numpy())
    (vc, ic), (vg, ig) = res["cpu"], res[str(cuda)]
    np.testing.assert_allclose(vg, vc, atol=1e-5, rtol=0)
    for r in range(len(q)):
        clear = vc[r] > vc[r, -1] + 2e-5
        assert set(ig[r][vg[r] > vc[r, -1] + 2e-5].tolist()) == set(ic[r][clear].tolist())


@pytest.mark.gpu
def test_engine_ivf_launches_phase_c(cuda, mixture, tmp_path):
    """SearchEngine(index="ivf") on the card: one block-major phase-C launch
    a search, two with rerank (the second in the f32 mode), no per-query
    launch and no plain fallback."""
    from merizo_search_tpu_torch.db import codecs
    from merizo_search_tpu_torch.search.engine import SearchEngine

    emb, q, lengths = mixture
    entries = [(f"d{i}", np.zeros((int(n), 3), np.float32), "A" * int(n))
               for i, n in enumerate(lengths)]
    codecs.write_pt_db(str(tmp_path / "db"), emb, entries)
    db = codecs.FlatDB.open(str(tmp_path / "db"))
    for rerank in (False, True):
        eng = SearchEngine(db, "bf16", "cuda", index="ivf", ivf_nlist=NLIST, ivf_nprobe=8,
                           ivf_rerank=rerank)
        eng.search(q[:2], K)                             # builds or opens the layout
        a0, c0 = counter(blockmax.LAUNCHES), counter(gather.LAUNCHES)
        b0, f0 = counter(gather.LAUNCHES_BY_BLOCK), counter(gather.LAUNCHES_BY_BLOCK_F32)
        vals, _ = eng.search(q, K)
        assert counter(gather.LAUNCHES_BY_BLOCK) - b0 == (2 if rerank else 1)
        assert counter(gather.LAUNCHES_BY_BLOCK_F32) - f0 == rerank
        assert counter(blockmax.LAUNCHES) == a0 and counter(gather.LAUNCHES) == c0
        assert np.isfinite(vals).all()


def _gather_problem(dev, dtype, q_n=45, nb=64, kb=37, seed=9):
    """Seeded unit rows (nb blocks; int8 with block scales) and queries on
    `dev`, with per-row lengths and query caps."""
    rng = np.random.default_rng(seed)
    n = nb * 128
    db = rng.normal(size=(n, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = rng.normal(size=(q_n, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    out = {"scales": None, "tl": t(rng.uniform(30, 140, n).astype(np.float32)),
           "qcap": t(rng.uniform(50, 150, q_n).astype(np.float32)), "nb": nb, "kb": kb}
    if dtype == "int8":
        d8, sc = topk.quantize_blocks(db)
        out.update(q=t(topk.quantize_rows(q)[0]), db=t(d8), scales=t(sc))
    elif dtype == "bf16":
        out.update(q=t(q).to(torch.bfloat16), db=t(db).to(torch.bfloat16))
    else:
        out.update(q=t(q), db=t(db))
    return out


def _bidx(case, q_n, nb, kb, rng):
    bidx = rng.integers(-1, nb, (q_n, kb))
    if case == "one_residue":              # every real slot in residue class 5
        bidx[np.arange(q_n) % 8 != 5] = -1
    elif case == "one_block_all_q":        # one block probed by every query
        bidx[:, 0] = 7
        bidx[:, kb // 2] = 7
    return bidx.astype(np.int32)


def _both_launches(p, bidx, n_valid, kw):
    """(per-query output, block-major output into a NaN-filled out=, a second
    block-major run): launched once each."""
    args = (p["q"], p["db"], bidx, n_valid)
    names = (gather.LAUNCHES, gather.LAUNCHES_BY_BLOCK)
    n0 = [counter(n) for n in names]
    want = gather.gather_block_scores(*args, **kw)
    out = torch.full_like(want, float("nan"))
    got = gather.gather_block_scores_by_block(*args, out=out, **kw)
    again = gather.gather_block_scores_by_block(*args, **kw)
    torch.cuda.synchronize()
    assert got is out
    assert [counter(n) for n in names] == [n0[0] + 1, n0[1] + 2]
    return want, got, again


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("scale", ["none", "scale_sel", "scales"])
@pytest.mark.parametrize("use_len", [False, True])
def test_by_block_equals_per_query_bit_for_bit(cuda, dtype, scale, use_len):
    p = _gather_problem(cuda, dtype)
    rng = np.random.default_rng(3)
    bidx = torch.from_numpy(_bidx("random", 45, p["nb"], p["kb"], rng)).to(cuda)
    bidx[:, 3] = p["nb"] - 1                      # n_valid cuts this block
    kw = {}
    if use_len:
        kw.update(tl=p["tl"], qcap=p["qcap"])
    sc = p["scales"] if p["scales"] is not None else torch.from_numpy(
        rng.uniform(0.5, 2, p["nb"] * 128).astype(np.float32)).to(cuda)
    if scale == "scale_sel":
        kw["scale_sel"] = selected_scales(sc, bidx)
    elif scale == "scales":
        kw["scales"] = sc
    want, got, again = _both_launches(p, bidx, p["nb"] * 128 - 77, kw)
    assert not torch.isnan(got).any()             # every slot was written
    assert torch.equal(got, want)
    assert torch.equal(again, got)                # the same bits run to run
    assert (got[bidx.repeat_interleave(128, dim=1) < 0] == NEG_CAP).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("case", ["one_residue", "one_block_all_q", "q1"])
def test_by_block_adversarial_lists(cuda, dtype, case):
    q_n = 1 if case == "q1" else 256 if case == "one_block_all_q" else 80
    p = _gather_problem(cuda, dtype, q_n=q_n, kb=21)
    bidx = torch.from_numpy(_bidx(case, q_n, p["nb"], 21, np.random.default_rng(4))).to(cuda)
    kw = {"tl": p["tl"], "qcap": p["qcap"]}
    if p["scales"] is not None:
        kw["scales"] = p["scales"]
    want, got, again = _both_launches(p, bidx, p["nb"] * 128, kw)
    assert not torch.isnan(got).any()
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(45, 37, 64), (64, 320, 10240), (3, 5, 1)])
def test_card_inversion_matches_plain(cuda, shape):
    """The card's CSR (a counting sort by atomics; at 10,240 blocks, 41 CTAs
    allocate the lists) read back equals invert_plain's."""
    q_n, kb, nb = shape
    bidx = torch.from_numpy(np.random.default_rng(6).integers(-2, nb + 2, (q_n, kb))
                            .astype(np.int32))
    want = gather.invert_plain(bidx, nb)
    got = gather.invert_blocks(bidx.to(cuda), nb)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
