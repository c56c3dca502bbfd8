"""The port's stream mode: a DB over the device budget, scanned in superblocks.

One mmap DB of 3,001 rows (not a multiple of 128) written by the port's
codecs, copied three ways: no sidecar, an int8 sidecar, a bf16 sidecar.
Each query has planted rows at cosines 0.95 down to 0.60 (0.05 apart);
every other row is a random unit vector (|cos| < 0.45).

- Stream mode (forced by a tiny `max_device_gb`, superblocks of 1,000
  rows: int8 rounds them to 896) against the port's device mode, every
  precision, with and without the sidecar and the mincov channel: scores
  equal bit for bit, indices equal except among tied scores.
- Against the JAX engine's stream mode on the same DB: the planted hits
  (score > 0.5) in the same order, scores within test_torch_search.py's
  tolerances (the JAX CPU scan keeps f32 queries and dequantises int8).
- `merge_partials` against JAX's, exactly; `_ordered_prefetch` keeps its
  order, raises at the failing item's turn and cancels on close.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from merizo_search_tpu.ops import topk as jtopk
from merizo_search_tpu.search.engine import SearchEngine as JaxEngine
from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.ops.topk import merge_partials
from merizo_search_tpu_torch.search import engine as eng_mod
from merizo_search_tpu_torch.search.engine import SearchEngine

N = 3001
BLOCK = 1000
COSINES = (0.95, 0.90, 0.85, 0.80, 0.75, 0.70, 0.65, 0.60)
SCORE_TOL = {"fp32": 2e-4, "bf16": 5e-3, "int8": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(17)
    q = rng.normal(size=(4, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    emb = rng.normal(size=(N, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for qi, e in enumerate(q):
        for j, cos in enumerate(COSINES):
            u = rng.normal(size=128)
            u -= (u @ e) * e
            u /= np.linalg.norm(u)
            emb[41 + 743 * qi + 87 * j] = cos * e + np.sqrt(1 - cos * cos) * u
    pool = [rng.normal(size=(n, 3)).astype(np.float32) for n in (60, 110, 180, 290)]
    w = codecs.MmapDBWriter(str(tmp / "plain" / "db"))
    for i, e in enumerate(emb):
        w.add(f"e{i:05d}", e, pool[i % 4], "A" * len(pool[i % 4]))
    w.finalize()
    out = {"none": str(tmp / "plain" / "db")}
    for kind in ("int8", "bf16"):
        shutil.copytree(tmp / "plain", tmp / kind)
        out[kind] = str(tmp / kind / "db")
        codecs.write_quantized_sidecar(out[kind], kind)
    return out, q, np.asarray([80, 150, 200, 300])


def _assert_same_topk(a, b):
    """Scores equal exactly; indices equal, except that rows with tied
    scores may come in either order (the merge sees them in another)."""
    np.testing.assert_array_equal(a[0], b[0])
    for va, ia, ib in zip(a[0], a[1], b[1]):
        for v in np.unique(va):
            tied = va == v
            if tied.sum() == 1:
                assert ia[tied] == ib[tied]
            elif v != va[-1]:       # a tie group cut by k may differ in its members
                assert sorted(ia[tied]) == sorted(ib[tied])


@pytest.mark.parametrize("precision,sidecar", [
    ("fp32", "none"), ("bf16", "none"), ("bf16", "bf16"), ("int8", "none"),
    ("int8", "int8")])
@pytest.mark.parametrize("mincov", [0.0, 0.7])
def test_stream_equals_device(dbs, precision, sidecar, mincov):
    paths, q, qlen = dbs
    db = codecs.FlatDB.open(paths[sidecar])
    assert db.has_quant(sidecar) or sidecar == "none"
    dev = SearchEngine(db, precision, "cpu")
    st = SearchEngine(db, precision, "cpu", max_device_gb=1e-9, stream_block=BLOCK)
    assert dev.mode == "device" and st.mode == "stream"
    want = dev.search(q, 25, query_lens=qlen, mincov=mincov)
    got = st.search(q, 25, query_lens=qlen, mincov=mincov)
    _assert_same_topk(got, want)
    rows = 896 if precision == "int8" else BLOCK        # int8 superblocks start on scale blocks
    assert st.stream_stats["block"] == rows
    assert st.stream_stats["superblocks"] == -(-N // rows)
    assert np.isfinite(got[0][:, :8]).all()


def test_stream_k_beyond_the_db_and_one_superblock(dbs):
    """k larger than the DB pads with -inf / -1; a superblock wider than
    the DB is one superblock."""
    paths, q, _ = dbs
    db = codecs.FlatDB.open(paths["none"])
    st = SearchEngine(db, "bf16", "cpu", max_device_gb=1e-9, stream_block=1 << 20)
    vals, idxs = st.search(q[:1], N + 5)
    assert st.stream_stats["superblocks"] == 1
    assert np.isfinite(vals[0, :N]).all() and (idxs[0, N:] == -1).all()
    assert sorted(idxs[0, :N]) == list(range(N))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("mincov", [0.0, 0.7])
def test_stream_matches_jax_stream(dbs, precision, mincov):
    import jax.numpy as jnp

    paths, q, qlen = dbs
    side = {"fp32": "none", "bf16": "bf16", "int8": "int8"}[precision]
    jdtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[precision]
    from merizo_search_tpu.db import codecs as jcodecs

    jeng = JaxEngine(jcodecs.FlatDB.open(paths[side]), chunk=64, dtype=jdtype,
                     max_device_gb=1e-9, stream_block=BLOCK)
    teng = SearchEngine(codecs.FlatDB.open(paths[side]), precision, "cpu",
                        max_device_gb=1e-9, stream_block=BLOCK)
    assert jeng.mode == teng.mode == "stream"
    jv, ji = jeng.search(q, 12, query_lens=qlen, mincov=mincov)
    tv, ti = teng.search(q, 12, query_lens=qlen, mincov=mincov)
    n_planted = 0
    for r in range(len(q)):
        keep = jv[r] > 0.5
        assert (tv[r] > 0.5).sum() == keep.sum()
        np.testing.assert_array_equal(ti[r][keep], ji[r][keep])
        np.testing.assert_allclose(tv[r][keep], jv[r][keep], atol=SCORE_TOL[precision])
        n_planted += int(keep.sum())
    assert n_planted >= (len(q) * len(COSINES) if mincov == 0.0 else len(q))


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(3)
    vals = -np.sort(-rng.normal(size=(5, 3, 7)).astype(np.float32), axis=2)
    vals[2, 1, 4:] = -np.inf
    idxs = rng.permutation(5 * 3 * 7).reshape(5, 3, 7).astype(np.int64)
    idxs[2, 1, 4:] = -1
    for k in (1, 7, 20):
        tv, ti = merge_partials(torch.from_numpy(vals), torch.from_numpy(idxs), k)
        jv, ji = jtopk.merge_partials(vals, idxs.astype(np.int32), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_ordered_prefetch_keeps_order():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, 40)

    def fn(i):
        time.sleep(delays[i])
        return i * i

    assert list(eng_mod._ordered_prefetch(range(40), fn, threads=4)) == [
        i * i for i in range(40)]


def test_ordered_prefetch_raises_at_the_failing_items_turn():
    def fn(i):
        if i == 5:
            raise ValueError("item 5")
        time.sleep(0.002 * (9 - i) if i < 10 else 0)
        return i

    got = []
    with pytest.raises(ValueError, match="item 5"):
        for x in eng_mod._ordered_prefetch(range(20), fn, threads=3):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_ordered_prefetch_cancels_on_close():
    started, lock = [], threading.Lock()

    def fn(i):
        with lock:
            started.append(i)
        time.sleep(0.02)
        return i

    gen = eng_mod._ordered_prefetch(range(1000), fn, threads=2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    time.sleep(0.1)
    with lock:
        n = len(started)
    # the window is threads + 1 calls: nothing past it started or starts later
    assert n <= 3 + 3
    time.sleep(0.05)
    assert len(started) == n


def test_stream_with_more_staging_threads_than_cores(dbs, monkeypatch):
    """16 staging threads (more than this machine's cores), 24 superblocks
    of 128 rows and a short switch interval: the merged result is still the
    device mode's, and every superblock was staged once."""
    import sys

    paths, q, qlen = dbs
    db = codecs.FlatDB.open(paths["int8"])
    want = SearchEngine(db, "int8", "cpu").search(q, 25, query_lens=qlen, mincov=0.7)
    monkeypatch.setenv("MERIZO_STAGE_THREADS", "16")
    st = SearchEngine(db, "int8", "cpu", max_device_gb=1e-9, stream_block=128)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = st.search(q, 25, query_lens=qlen, mincov=0.7)
    finally:
        sys.setswitchinterval(interval)
    _assert_same_topk(got, want)
    assert st.stream_stats["superblocks"] == -(-N // 128)
    assert st.stream_stats["stage_thread_s"] > 0


def test_stream_needs_the_card_when_asked_for_it(dbs):
    """The stream mode runs on the device the engine was given: asking for
    the card without one raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    paths, _, _ = dbs
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine(codecs.FlatDB.open(paths["none"]), "bf16", "cuda", max_device_gb=1e-9)


def test_run_dbsearch_with_a_stream_engine(dbs, tmp_path):
    """run_dbsearch(engine=<stream engine>) on segmenter-style query dicts
    gives the device-mode results, with the domain fields on every hit."""
    from merizo_search_tpu_torch.models import foldclass as tfc
    from merizo_search_tpu_torch.pipeline.dbsearch import run_dbsearch

    paths, _, _ = dbs
    golden = os.path.join(os.path.dirname(__file__), "golden", "foldclass.npz")
    z = np.load(golden)
    model = tfc.FoldClassNet()
    model.load_state_dict({k[3:]: torch.from_numpy(z[k]) for k in z.files
                           if k.startswith("sd.")})
    model.eval()
    db = codecs.FlatDB.open(paths["int8"])
    queries = [{"name": f"chain_merizo_{i + 1:02d}", "coords": db.coords(i * 7),
                "seq": db.seq(i * 7), "dom_str": f"{i + 1}-{i + 50}",
                "dom_conf": 0.5 + i / 10, "dom_plddt": 70.0 + i} for i in range(3)]
    out = {}
    for mode, budget in (("device", 8.0), ("stream", 1e-9)):
        engine = SearchEngine(db, "int8", "cpu", max_device_gb=budget, stream_block=BLOCK)
        assert engine.mode == mode
        out[mode] = run_dbsearch(queries, paths["int8"], topk=5, mincos=-1.0, mintm=0.0,
                                 inputs_are_ca=True, model=model, engine=engine,
                                 device="cpu")
    for a, b in zip(out["device"][0], out["stream"][0]):
        assert len(a) == 5
        assert [(h["target"], h["score"], h["tmalign_output"]) for h in a.values()] == [
            (h["target"], h["score"], h["tmalign_output"]) for h in b.values()]
    hit = out["stream"][0][2][0]
    assert (hit["dom_str"], hit["dom_conf"], hit["dom_plddt"]) == ("3-52", 0.7, 72.0)
