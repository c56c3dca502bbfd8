"""The mesh modes on the card: the DB sharded over a list of devices in one
process (flat, stream and IVF), and the data-parallel embed.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device; the tests on distinct cards skip below two
cards. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mesh_gpu.py

On one card the mesh repeats cuda:0 (four shards on one card, as
chip_smoke.py runs them); with two or more, `make_mesh` gives distinct
cards, whose kernels launch on their own card and stream whoever calls.
A mesh's result equals the one-device engine's: scores bit for bit (each
shard scores a row as one device does; the merge is exact), indices equal
except among tied scores; fp32 (the plain scan's matmul on other shapes)
within 1e-6; embeddings within 1e-4.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.device import make_mesh
from merizo_search_tpu_torch.ops import blockmax, gather
from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params
from merizo_search_tpu_torch.search.engine import SearchEngine
from merizo_search_tpu_torch.utils.profiling import counter, reset_counters

N = 20_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA devices for distinct cards (found {n})")
    return make_mesh(1 << (n.bit_length() - 1), "cuda")   # a power of two: nlist 64 shards


@pytest.fixture(params=["repeated", "distinct"])
def mesh(request, cuda):
    if request.param == "repeated":
        return (torch.device("cuda", 0),) * 4
    return request.getfixturevalue("cards")


@pytest.fixture(scope="module")
def db_prefix(tmp_path_factory):
    """20,000 rows (not a multiple of 128 rows a shard) around 64 centres,
    with int8 and bf16 sidecars."""
    rng = np.random.default_rng(8)
    cent = rng.normal(size=(64, 128)).astype(np.float32)
    emb = (cent[rng.integers(0, 64, N)] + 0.5 * rng.normal(size=(N, 128))).astype(np.float32)
    pool = [rng.normal(size=(n, 3)).astype(np.float32) for n in (60, 140, 250)]
    prefix = str(tmp_path_factory.mktemp("mesh_gpu") / "db")
    w = codecs.MmapDBWriter(prefix)
    for i, e in enumerate(emb):
        w.add(f"e{i:05d}", e, pool[i % 3], "A" * len(pool[i % 3]))
    w.finalize()
    for kind in ("int8", "bf16"):
        codecs.write_quantized_sidecar(prefix, kind)
    return prefix


def _queries(n=40):
    rng = np.random.default_rng(1)
    return rng.normal(size=(n, 128)).astype(np.float32), rng.integers(50, 300, n)


def _assert_same(a, b, precision):
    if precision == "fp32":
        np.testing.assert_allclose(a[0], b[0], atol=1e-6)
        return
    np.testing.assert_array_equal(a[0], b[0])
    for va, ia, ib in zip(a[0], a[1], b[1]):
        for v in np.unique(va):
            tied = va == v
            assert sorted(ia[tied].tolist()) == sorted(ib[tied].tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["bf16", "int8", "fp32"])
@pytest.mark.parametrize("stream", [False, True])
def test_flat_mesh_equals_one_device(db_prefix, mesh, precision, stream):
    q, qlen = _queries()
    db = codecs.FlatDB.open(db_prefix)
    kw = dict(max_device_gb=1e-9, stream_block=3000) if stream else {}
    eng = SearchEngine(db, precision, "cuda", mesh=mesh, **kw)
    assert eng.mode == ("stream" if stream else "device")
    want = SearchEngine(db, precision, "cuda").search(q, 100, query_lens=qlen, mincov=0.7)
    eng.search(q[:1], 100)                       # residency before the counts
    reset_counters()
    got = eng.search(q, 100, query_lens=qlen, mincov=0.7)
    _assert_same(got, want, precision)
    if precision != "fp32":
        items = eng.stream_stats["superblocks"] if stream else 1
        assert counter(blockmax.LAUNCHES) == counter(gather.LAUNCHES) == items * len(mesh)


@pytest.mark.gpu
@pytest.mark.parametrize("precision,rerank", [("bf16", False), ("bf16", True),
                                              ("int8", False), ("fp32", False)])
def test_ivf_mesh_equals_one_device(db_prefix, mesh, precision, rerank):
    q, qlen = _queries()
    db = codecs.FlatDB.open(db_prefix)
    kw = dict(index="ivf", ivf_nlist=64, ivf_nprobe=8, ivf_rerank=rerank)
    want = SearchEngine(db, precision, "cuda", **kw).search(q, 50, query_lens=qlen, mincov=0.7)
    eng = SearchEngine(db, precision, "cuda", mesh=mesh, **kw)
    eng.search(q[:1], 50)
    reset_counters()
    got = eng.search(q, 50, query_lens=qlen, mincov=0.7)
    assert eng.ivf_build_s is None               # the one-device engine's cached layout
    _assert_same(got, want, precision)
    assert counter(gather.LAUNCHES_BY_BLOCK) == len(mesh) * (2 if rerank else 1)
    assert counter(gather.LAUNCHES) == counter(blockmax.LAUNCHES) == 0


@pytest.mark.gpu
def test_stream_ivf_mesh_equals_one_device(db_prefix, mesh):
    q, qlen = _queries()
    db = codecs.FlatDB.open(db_prefix)
    kw = dict(index="ivf", ivf_nlist=64, ivf_nprobe=8, max_device_gb=1e-9, stream_block=4000)
    want = SearchEngine(db, "bf16", "cuda", **kw).search(q, 50, query_lens=qlen, mincov=0.7)
    eng = SearchEngine(db, "bf16", "cuda", mesh=mesh, **kw)
    reset_counters()
    got = eng.search(q, 50, query_lens=qlen, mincov=0.7)
    _assert_same(got, want, "bf16")
    assert counter(blockmax.LAUNCHES) == eng.stream_stats["groups"] * len(mesh)


@pytest.mark.gpu
def test_embed_data_parallel(mesh):
    rng = np.random.default_rng(3)
    cl = [(rng.normal(size=(int(n), 3)) * 8).astype(np.float32)
          for n in rng.integers(40, 400, 37)]
    model = load_foldclass_params(None, "cuda")
    got = embed_structures(model, cl, mesh=mesh)
    np.testing.assert_allclose(got, embed_structures(model, cl), atol=1e-4)
    assert set(model.mesh_replicas) == set(mesh) - {torch.device("cuda", 0)}


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_card(cards):
    """Phase A and C on the last card while the process's current device is
    cuda:0: each launches on its tensors' card and stream (the wrappers'
    device guard) and equals its plain version there."""
    from merizo_search_tpu_torch.ops.fused_scan import select_blocks

    dev = cards[-1]
    torch.cuda.set_device(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    db = torch.randn((1 << 16, 128), generator=gen, device=dev)
    db = (db / db.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn((32, 128), generator=gen, device=dev).to(torch.bfloat16)
    bm = blockmax.blockmax_scan(q, db, db.shape[0])
    assert torch.cuda.current_device() == 0
    torch.testing.assert_close(bm, blockmax.blockmax_plain(q, db, db.shape[0]), atol=1e-5,
                               rtol=0)
    bidx = select_blocks(bm, db.shape[0], 10)
    for fn in (gather.gather_block_scores, gather.gather_block_scores_by_block):
        got = fn(q, db, bidx, db.shape[0])
        torch.testing.assert_close(got, gather.gather_plain(q, db, bidx, db.shape[0]),
                                   atol=1e-5, rtol=0)
    torch.cuda.synchronize(dev)
