"""Phase B's select kernel (csrc/select.cu) against its plain version, on the card.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_select_gpu.py

The kernel and `phase_b_plain` (on the CPU) select by the same exact order,
so `bidx` and `scale_sel` must be equal bit for bit, at every shape the
planner takes: one level (CATH's NB 3,907), two (TED's shard, NB 356,441),
more (a k whose candidates outgrow one merge), and the sort path (K above
SORT_K). Block maxima are random floats made on the card from a seed, so no
DB is needed; the patterns add ties across slice edges, signed zeros and
rows of NEG_CAP.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.db.codecs import FlatDB
from merizo_search_tpu_torch.ops import blockmax, gather, select, topk
from merizo_search_tpu_torch.ops.fused_scan import cover_check
from merizo_search_tpu_torch.search.engine import SearchEngine
from merizo_search_tpu_torch.utils import profiling

NEG_CAP = -3.4e38


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bm(nq, nb, pattern, dev, seed=5):
    """Block maxima [nq, nb] float32 on the card: normal floats, or with
    `ties` a handful of values (runs of ties across every slice edge),
    `zeros` half of them +0.0 / -0.0, `negcap` the second half of each row
    and two whole rows NEG_CAP."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bm = torch.randn((nq, nb), generator=gen, device=dev)
    if pattern == "ties":
        bm = torch.round(bm * 2) / 2
    elif pattern == "zeros":
        z = torch.rand((nq, nb), generator=gen, device=dev) < 0.5
        sign = torch.rand((nq, nb), generator=gen, device=dev) < 0.5
        bm = torch.where(z, torch.where(sign, -0.0, 0.0), bm)
    elif pattern == "negcap":
        bm[:, nb // 2:] = NEG_CAP
        bm[: min(2, nq)] = NEG_CAP
    return bm.contiguous()


def _check(bm, n_valid, k, scales=None):
    got = select.phase_b(bm, n_valid, k, scales)
    torch.cuda.synchronize()
    want = select.phase_b_plain(bm.cpu(), n_valid, k, None if scales is None else scales.cpu())
    assert torch.equal(got[0].cpu(), want[0])
    if scales is not None:
        assert torch.equal(got[1].cpu(), want[1])
    return got


CASES = [   # (Q, NB, k): the levels each takes in the comments
    (256, 356_441, 100),    # TED's shard: 18 slices, then one merge
    (256, 3_907, 100),      # CATH: one launch
    (32, 3_907, 10),
    (1, 3_907, 10),
    (32, 356_441, 1),
    (7, 1, 5),              # NB = 1
    (5, 60, 100),           # NB < KB: every block
    (3, 20_483, 10),        # a ragged last slice
    (2, 190_000, 1_000),    # K above the prefilter, candidates over two merge levels
    (4, 30_000, 1_000),     # K above the prefilter: the whole slice's select
    (2, 500_000, 2_047),    # candidates outgrow one merge: four levels
    (3, 20_000, 3_000),     # K above SORT_K: the sort path
]


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["random", "ties", "zeros", "negcap"])
@pytest.mark.parametrize("nq, nb, k", CASES)
def test_select_kernel_matches_plain(cuda, nq, nb, k, pattern):
    bm = _bm(nq, nb, pattern, cuda)
    scales = torch.rand(nb, device=cuda).repeat_interleave(128)
    _check(bm, (nb // 2) * 128 + 17, k, scales)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["first", "middle", "last", "selected"])
@pytest.mark.parametrize("nq, nb, k", [(64, 356_441, 100), (32, 3_907, 10), (4, 20_000, 3_000)])
def test_straddling_block_on_card(cuda, nq, nb, k, where):
    """The straddling block in column K wherever it lies, and -1 in the
    top columns where the selection already holds it."""
    bm = _bm(nq, nb, "random", cuda)
    n_valid = {"first": 5, "middle": (nb // 2) * 128 + 3, "last": nb * 128 + 999,
               "selected": (nb // 3) * 128 + 64}[where]
    straddle = min(n_valid // 128, nb - 1)
    if where == "selected":
        bm[:, straddle] = 50.0
    bidx = _check(bm, n_valid, k)[0].cpu()
    assert torch.all(bidx[:, -1] == straddle)
    if where == "selected":
        assert torch.all(bidx[:, 0] == -1)


@pytest.mark.gpu
def test_selected_scales_kernel_matches_plain(cuda):
    bm = _bm(16, 3_907, "random", cuda)
    scales = torch.rand(3_907, device=cuda).repeat_interleave(128)
    bidx = select.phase_b(bm, 3_907 * 128 - 5, 10)[0]
    got = select.selected_scales(scales, bidx)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), select.scales_plain(scales.cpu(), bidx.cpu()))


@pytest.mark.gpu
def test_cover_invariant_at_2p24_int8(cuda):
    """Phase A's BM at 2^24 int8 rows, Q 256, k 100, the kernel's selection,
    phase C on it: every compared block's max is its BM."""
    from merizo_search_tpu_torch.tools import _bench_util as bu

    gen = torch.Generator(device=cuda).manual_seed(7)
    n = 1 << 24
    db, sc = bu.make_db(n, "int8", gen, cuda)
    q = torch.randn((256, 128), generator=gen, device=cuda).mul_(40).clamp_(-127, 127)
    q = q.to(torch.int8)
    bm = blockmax.blockmax_scan(q, db, n, scales=sc)
    bidx, ss = select.phase_b(bm, n, 100, sc)
    scores = gather.gather_block_scores(q, db, bidx, n, scale_sel=ss)
    compared, differ = cover_check(bm, scores, bidx, n)
    assert compared >= 256 * 100 and differ == 0


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [500_000, 2_000_000])
def test_engine_search_launches_the_select_kernel(cuda, rows):
    """One engine.search call (int8, device mode) launches the select
    kernel as `select.launches` plans it (one level at 3,907 blocks, two at
    15,625), and phase B on a CPU tensor launches nothing."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(rows, 128)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rows8, scales = topk.quantize_blocks(x)
    db = FlatDB("mmap", prefix=None, _emb=None, _emb8=rows8, _scales=scales,
                _lengths=np.broadcast_to(np.int32(0), (rows,)), size=rows, dim=128,
                normalised=True)
    engine = SearchEngine(db, dtype="int8", device=cuda)
    assert engine.mode == "device"
    q = x[rng.integers(0, rows, 256)]
    engine.search(q, 100)
    nb = -(-rows // 128)
    before = profiling.counter(select.LAUNCHES)
    _, idx = engine.search(q, 100)
    assert profiling.counter(select.LAUNCHES) - before == select.launches(nb, 100)
    assert select.launches(nb, 100) == (1 if nb <= select.WMAX else 2)
    assert (idx[:, 0] >= 0).all()
    before = profiling.counter(select.LAUNCHES)
    select.phase_b(torch.randn(4, nb), rows, 100)
    assert profiling.counter(select.LAUNCHES) == before
