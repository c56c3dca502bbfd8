"""The port's IVF index (search/ivf.py, the engine's IVF modes, the CLI's
--search_index ivf) against the JAX package's, on the CPU.

Data: tests/test_ivf.py's mixture (2^13 unit rows around 32 centres, 8
queries near DB rows, its own default_rng(1234)), nlist 64. Both packages
search ONE layout (the JAX build, or caches and sidecars written by one
package and opened by the other), so the comparisons are of the search:

- build: the port's layout is balanced (each row once as primary,
  duplicates only in spare slots), centroids within 1e-4 of JAX's and perm
  equal (where a score tie moves a row, each cluster's member set is
  compared instead);
- ivf_search: scores within 1e-5 of JAX `ivf_search(interpret=True)`, id
  sets equal except among scores within 1e-5 of the k-th (ties);
- nprobe = nlist equals the port's flat fused scan exactly (bf16);
- rerank values are the float64 dots within 1e-6;
- engines: caches and disk sidecars interchange; device-mode hits match
  within 1e-5 (both scan the storage-dtype query), stream mode within
  5e-3 (JAX's CPU stream IVF scores f32 queries against the stored rows;
  the port scores bf16 or int8 queries, as on the card), as
  tests/test_torch_search.py does for the flat scan.
"""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merizo_search_tpu.db import codecs as jcodecs
from merizo_search_tpu.search import ivf as jivf
from merizo_search_tpu.search.engine import SearchEngine as JEngine
from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.ops.fused_scan import fused_topk
from merizo_search_tpu_torch.ops.topk import quantize_blocks, quantize_rows
from merizo_search_tpu_torch.search import ivf as tivf
from merizo_search_tpu_torch.search.engine import SearchEngine

NLIST, K, TOL = 64, 10, 1e-5
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixture():
    rng = np.random.default_rng(1234)
    n, d = 1 << 13, 128
    centers = rng.normal(size=(32, d)).astype(np.float32) * 3
    emb = centers[rng.integers(0, 32, n)] + rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.choice(n, 8, replace=False)].copy()
    q += rng.normal(size=q.shape).astype(np.float32) * 0.02
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    lengths = rng.integers(50, 300, n).astype(np.float32)
    return emb, q, lengths


@pytest.fixture(scope="module")
def layout(mixture):
    return jivf.build_ivf(mixture[0], nlist=NLIST, seed=1)


def _assert_same_topk(vt, it, vj, ij, tol):
    """Scores within tol; id sets equal except among entries within tol of
    the k-th score (ties may be broken either way)."""
    vt, vj = np.asarray(vt, np.float64), np.asarray(vj, np.float64)
    np.testing.assert_allclose(vt, vj, atol=tol, rtol=0)
    for r in range(vt.shape[0]):
        last = vj[r, -1]
        clear_t = set(np.asarray(it)[r][vt[r] > last + 2 * tol].tolist())
        clear_j = set(np.asarray(ij)[r][vj[r] > last + 2 * tol].tolist())
        assert clear_t == clear_j


# -- build --------------------------------------------------------------------

@pytest.mark.parametrize("expand", [0.0, 0.25])
def test_build_matches_jax(mixture, expand):
    emb = mixture[0]
    j = jivf.build_ivf(emb, nlist=NLIST, seed=1, expand=expand)
    t = tivf.build_ivf(emb, nlist=NLIST, seed=1, expand=expand, device="cpu")
    c, perm = t["cluster_rows"], t["perm"]
    assert (t["nlist"], c, len(perm), t["dup"]) == (j["nlist"], j["cluster_rows"],
                                                    len(j["perm"]), j["dup"])
    valid = perm[perm >= 0]
    assert len(np.unique(valid)) == len(emb)                  # every row present
    assert len(valid) - len(emb) <= len(perm) - len(emb)      # duplicates fit the slack
    assert t["dup"] == (len(valid) > len(emb))
    for cl in range(NLIST):                                   # no row twice in a cluster
        rows = perm[cl * c:(cl + 1) * c]
        rows = rows[rows >= 0]
        assert len(np.unique(rows)) == len(rows)
    np.testing.assert_allclose(t["centroids"], j["centroids"], atol=1e-4, rtol=0)
    if not np.array_equal(perm, j["perm"]):
        # a preference score tie broke the other way: the clusters must
        # still hold the same members
        for cl in range(NLIST):
            a, b = perm[cl * c:(cl + 1) * c], j["perm"][cl * c:(cl + 1) * c]
            assert sorted(a[a >= 0]) == sorted(b[b >= 0])


# -- search ---------------------------------------------------------------------

def _operands(emb, q, ivf, dtype):
    """(jax args, jax kwargs, torch args, torch kwargs) of one ivf_search on
    the shared layout in `dtype` (int8: blocks quantised over the permuted
    layout, int8 queries for the scan, f32 queries for the probe)."""
    f32 = jivf.permute_db(emb, ivf)
    cent, perm = ivf["centroids"], ivf["perm"]
    if dtype == "bf16":
        ja = (jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(f32).astype(jnp.bfloat16))
        ta = (torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(f32).to(torch.bfloat16))
        jk, tk = {}, {}
    else:
        d8, sc = quantize_blocks(f32)
        q8, _ = quantize_rows(q)
        ja, ta = (jnp.asarray(q), jnp.asarray(d8)), (torch.from_numpy(q), torch.from_numpy(d8))
        jk = {"scales": jnp.asarray(sc), "q8": jnp.asarray(q8)}
        tk = {"scales": torch.from_numpy(sc), "q8": torch.from_numpy(q8)}
    ja += (jnp.asarray(cent), jnp.asarray(perm))
    ta += (torch.from_numpy(cent), torch.from_numpy(perm))
    return ja, jk, ta, tk, f32


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("mincov", [0.0, 0.7])
def test_ivf_search_matches_jax(mixture, layout, dtype, rerank, dedup, mincov):
    emb, q, lengths = mixture
    ja, jk, ta, tk, f32 = _operands(emb, q, layout, dtype)
    perm = layout["perm"]
    lp = np.full(len(perm), 1e9, np.float32)
    lp[perm >= 0] = lengths[perm[perm >= 0]]
    qlen = np.full(len(q), 150.0, np.float32)
    if mincov:
        jk.update(tlen=jnp.asarray(lp), qlen=jnp.asarray(qlen), mincov=mincov, use_len=True)
        tk.update(tlen=torch.from_numpy(lp), qlen=torch.from_numpy(qlen), mincov=mincov,
                  use_len=True)
    if rerank:
        jk.update(rerank_hi=jnp.asarray(f32), q_hi=jnp.asarray(q))
        tk.update(rerank_hi=torch.from_numpy(f32), q_hi=torch.from_numpy(q))
    vj, ij = jivf.ivf_search(*ja, K, 8, interpret=True, dedup=dedup, **jk)
    vt, it = tivf.ivf_search(*ta, K, 8, dedup=dedup, **tk)
    assert vt.shape == (len(q), K) and it.dtype == torch.int64
    _assert_same_topk(vt.numpy(), it.numpy(), np.asarray(vj), np.asarray(ij), TOL)
    if mincov:
        for v, i in zip(vt.numpy().ravel(), it.numpy().ravel()):
            assert i < 0 or 150.0 >= lengths[i] * mincov
    if dedup:
        for r in range(len(q)):
            got = it[r][it[r] >= 0].tolist()
            assert len(set(got)) == len(got)


def test_full_probe_equals_the_flat_scan(mixture, layout):
    """nprobe = nlist with dedup: the port's flat fused scan, scores bit
    for bit (bf16, both through phase C's plain version)."""
    emb, q, _ = mixture
    _, _, ta, _, _ = _operands(emb, q, layout, "bf16")
    vt, it = tivf.ivf_search(*ta, K, NLIST, dedup=True)
    fv, fi = fused_topk(ta[0], torch.from_numpy(emb).to(torch.bfloat16), len(emb), K)
    assert torch.equal(vt, fv)
    for r in range(len(q)):
        for v in torch.unique(fv[r]):
            tied = fv[r] == v
            assert sorted(it[r][tied].tolist()) == sorted(fi[r][tied].tolist())


def test_rerank_values_are_the_f64_dots(mixture, layout):
    emb, q, _ = mixture
    _, _, ta, tk, f32 = _operands(emb, q, layout, "bf16")
    vt, it = tivf.ivf_search(*ta, K, 16, dedup=True, rerank_hi=torch.from_numpy(f32),
                             q_hi=torch.from_numpy(q))
    exact = np.take_along_axis(q.astype(np.float64) @ emb.T.astype(np.float64),
                               it.numpy(), axis=1)
    np.testing.assert_allclose(vt.numpy(), exact, atol=1e-6, rtol=0)


def test_dedup_topk_pads_to_k():
    """_dedup_topk returns exactly k columns even when the candidate pool
    is narrower than k (or has fewer unique finite ids); big ids survive
    the sorts (the JAX test's case)."""
    v = torch.tensor([[3.0, 1.0, 3.0, 2.0], [5.0, -np.inf, 5.0, -np.inf]])
    idx = torch.tensor([[7, 9, 7, 400000], [123456, -1, 123456, -1]])
    out_v, out_i = tivf._dedup_topk(v, idx, 6)
    assert out_v.shape == (2, 6) and out_i.shape == (2, 6)
    assert out_i[0].tolist() == [7, 400000, 9, -1, -1, -1]
    np.testing.assert_allclose(out_v[0, :3].numpy(), [3.0, 2.0, 1.0])
    assert torch.isneginf(out_v[0, 3:]).all()
    assert out_i[1, 0] == 123456 and (out_i[1, 1:] == -1).all()


def test_cluster_runs_and_disk_words(tmp_path, mixture):
    """cluster_runs coalesces as JAX's does, and a bf16 sidecar written
    by JAX (ml_dtypes bfloat16) reads as the same 16-bit words in the port,
    and the reverse."""
    emb, _, lengths = mixture
    ids = np.array([0, 1, 2, 5, 7, 8, 63])
    assert tivf.cluster_runs(ids) == jivf.cluster_runs(ids)
    assert tivf.cluster_runs(np.array([], np.int64)) == []
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jivf.write_disk_ivf(emb, lengths, NLIST, jp, precision="bf16", fingerprint=[1, 2])
    tivf.write_disk_ivf(emb, lengths, NLIST, tp, precision="bf16", fingerprint=[1, 2],
                        device="cpu")
    for name in (".emb", ".perm", ".len"):
        with open(jp + name, "rb") as a, open(tp + name, "rb") as b:
            assert a.read() == b.read(), name
    a, b = tivf.load_disk_ivf(jp), jivf.load_disk_ivf(tp)
    assert np.array_equal(a["emb"], np.asarray(b["emb"]).view(np.uint16))
    np.testing.assert_array_equal(a["centroids"], b["centroids"])
    assert a["dup"] == b["dup"] and list(a["fingerprint"]) == [1, 2]


# -- engines --------------------------------------------------------------------

def _write_db(prefix, emb, lengths):
    entries = [(f"d{i:05d}", np.zeros((int(n), 3), np.float32), "A" * int(n))
               for i, n in enumerate(lengths)]
    codecs.write_pt_db(prefix, emb, entries)


def _forbid_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the cache or sidecar was rebuilt instead of opened")

    monkeypatch.setattr(jivf, "build_ivf", no_build)
    monkeypatch.setattr(tivf, "build_ivf", no_build)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engine_cache_interchanges(tmp_path, monkeypatch, mixture, precision, writer):
    """The .ivf{nlist}.npz cache written by either engine opens in the
    other (no rebuild) and both return the same hits, mincov on."""
    emb, q, lengths = mixture
    prefix = str(tmp_path / "db")
    _write_db(prefix, emb, lengths)
    qlen = np.full(len(q), 150, np.int32)
    kw = dict(k=K, query_lens=qlen, mincov=0.7)

    def jax_engine():
        return JEngine(jcodecs.FlatDB.open(prefix), dtype=JDTYPE[precision], index="ivf",
                       ivf_nlist=NLIST, ivf_nprobe=8)

    def port_engine():
        return SearchEngine(codecs.FlatDB.open(prefix), precision, "cpu", index="ivf",
                            ivf_nlist=NLIST, ivf_nprobe=8)

    first, second = (jax_engine, port_engine) if writer == "jax" else (port_engine, jax_engine)
    a = first().search(q, **kw)
    assert os.path.exists(f"{prefix}.ivf{NLIST}.npz")
    _forbid_build(monkeypatch)
    b = second().search(q, **kw)
    (vt, it), (vj, ij) = (b, a) if writer == "jax" else (a, b)
    _assert_same_topk(vt, it, vj, ij, TOL)


def test_engine_rebuilds_a_stale_cache(tmp_path, mixture):
    """A DB rewritten under the same prefix invalidates the cache: at
    nprobe = nlist the hits follow the new row order."""
    emb, q, lengths = mixture
    prefix = str(tmp_path / "stale")
    _write_db(prefix, emb, lengths)
    SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", index="ivf", ivf_nlist=NLIST,
                 ivf_nprobe=NLIST).search(q[:2], 5)
    perm = np.random.default_rng(9).permutation(len(emb))
    _write_db(prefix, emb[perm], lengths[perm])
    st = os.stat(prefix + ".pt")
    os.utime(prefix + ".pt", (st.st_atime, st.st_mtime + 10))
    eng = SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", index="ivf",
                       ivf_nlist=NLIST, ivf_nprobe=NLIST)
    _, i2 = eng.search(q[:2], 5)
    assert eng.ivf_build_s is not None
    ref = np.argsort(-(q[:2] @ emb[perm].T), axis=1)[:, :5]
    for r in range(2):
        assert set(i2[r].tolist()) == set(ref[r].tolist())


def test_engine_ivf_rerank_and_recall(tmp_path, mixture):
    emb, q, lengths = mixture
    prefix = str(tmp_path / "db")
    _write_db(prefix, emb, lengths)
    s = q.astype(np.float64) @ emb.T.astype(np.float64)
    ref = np.argsort(-s, axis=1)[:, :5]
    for precision in ("bf16", "int8"):
        eng = SearchEngine(codecs.FlatDB.open(prefix), precision, "cpu", index="ivf",
                           ivf_nlist=NLIST, ivf_nprobe=16, ivf_rerank=True)
        vals, idxs = eng.search(q, 5)
        rec = np.mean([len(set(idxs[r]) & set(ref[r])) / 5 for r in range(len(q))])
        assert rec > 0.9
        np.testing.assert_allclose(vals, np.take_along_axis(s, idxs, 1), atol=1e-6)


@pytest.mark.parametrize("precision,writer", [("bf16", "jax"), ("fp32", "jax"),
                                              ("fp32", "port"), ("int8", "port")])
def test_stream_ivf_matches_jax(tmp_path, monkeypatch, mixture, precision, writer):
    """Stream IVF (max_device_gb=1e-9) in both packages over ONE disk
    sidecar set, written by `writer` and opened by the other."""
    emb, q, lengths = mixture
    prefix = str(tmp_path / "db")
    _write_db(prefix, emb, lengths)
    qlen = np.full(len(q), 150, np.int32)
    kw = dict(k=K, query_lens=qlen, mincov=0.7)

    def jax_engine():
        return JEngine(jcodecs.FlatDB.open(prefix), dtype=JDTYPE[precision], index="ivf",
                       ivf_nlist=NLIST, ivf_nprobe=8, max_device_gb=1e-9,
                       stream_block=1000)

    def port_engine():
        return SearchEngine(codecs.FlatDB.open(prefix), precision, "cpu", index="ivf",
                            ivf_nlist=NLIST, ivf_nprobe=8, max_device_gb=1e-9,
                            stream_block=1000)

    first, second = (jax_engine, port_engine) if writer == "jax" else (port_engine, jax_engine)
    e1 = first()
    assert e1.mode == "stream"
    a = e1.search(q, **kw)
    prec = {"fp32": "f32"}.get(precision, precision)
    assert os.path.exists(f"{prefix}.ivfdisk{NLIST}.{prec}.npz")
    _forbid_build(monkeypatch)
    e2 = second()
    b = e2.search(q, **kw)
    port = e2 if writer == "jax" else e1
    (vt, it), (vj, ij) = (b, a) if writer == "jax" else (a, b)
    _assert_same_topk(vt, it, vj, ij, TOL if precision == "fp32" else 5e-3)
    stats = port.stream_stats
    assert stats["groups"] >= 2 and 0 < stats["staged_share"] <= 1
    assert stats["rows_staged"] == stats["clusters"] * port._sivf["cluster_rows"]


def test_stream_ivf_full_probe_equals_device_flat(tmp_path, mixture):
    """Stream IVF at nprobe = nlist stages every cluster: the device-mode
    flat engine's hits, scores bit for bit (bf16)."""
    emb, q, lengths = mixture
    prefix = str(tmp_path / "db")
    _write_db(prefix, emb, lengths)
    db = codecs.FlatDB.open(prefix)
    st = SearchEngine(db, "bf16", "cpu", index="ivf", ivf_nlist=NLIST, ivf_nprobe=NLIST,
                      max_device_gb=1e-9, stream_block=1000)
    got = st.search(q, K)
    want = SearchEngine(db, "bf16", "cpu").search(q, K)
    assert st.stream_stats["clusters"] == NLIST
    np.testing.assert_array_equal(got[0], want[0])
    for r in range(len(q)):
        for v in np.unique(want[0][r]):
            tied = want[0][r] == v
            assert sorted(got[1][r][tied]) == sorted(want[1][r][tied])


@pytest.mark.parametrize("kind", ["flat", "ivf", "stream_ivf"])
def test_threads_share_one_load(tmp_path, monkeypatch, mixture, kind):
    """Eight threads searching one fresh engine: one load (residency, the
    IVF layout, or the disk sidecars), and every thread's result equal."""
    emb, q, lengths = mixture
    prefix = str(tmp_path / "db")
    _write_db(prefix, emb, lengths)
    name = "_load_stream_ivf_now" if kind == "stream_ivf" else "_load_resident_now"
    loads, orig = [], getattr(SearchEngine, name)

    def counted(self):
        loads.append(threading.get_ident())
        return orig(self)

    monkeypatch.setattr(SearchEngine, name, counted)
    kw = {} if kind == "flat" else dict(index="ivf", ivf_nlist=NLIST, ivf_nprobe=8)
    if kind == "stream_ivf":
        kw.update(max_device_gb=1e-9, stream_block=2000)
    eng = SearchEngine(codecs.FlatDB.open(prefix), "bf16", "cpu", **kw)
    out, errors, barrier = [None] * 8, [], threading.Barrier(8)

    def work(i):
        try:
            barrier.wait()
            out[i] = eng.search(q, K)
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # switch often, so a race would show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(loads) == 1
    for v, i in out[1:]:
        np.testing.assert_array_equal(v, out[0][0])
        np.testing.assert_array_equal(i, out[0][1])


def test_dedup_topk_keeps_the_best_copy():
    """The merge of the stream IVF: among copies of one id, the best score
    wins; invalid ids never count."""
    pv = torch.tensor([[0.5, 0.9, 0.9, 0.1, -np.inf]])
    pi = torch.tensor([[3, 8, 8, 3, -1]])
    v, i = tivf._dedup_topk(pv, pi, 4)
    assert i[0].tolist() == [8, 3, -1, -1]
    np.testing.assert_allclose(v[0, :2].numpy(), [0.9, 0.5])
    assert torch.isneginf(v[0, 2:]).all()


# -- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A pt DB of 3,000 rows with planted hits for three query PDBs (cosines
    0.98-0.78 to each query's own embedding), and one weights file."""
    from merizo_search_tpu_torch.models import foldclass as tfc
    from merizo_search_tpu_torch.pipeline.embed import embed_structures

    d = tmp_path_factory.mktemp("ivf_cli")
    z = np.load(os.path.join(os.path.dirname(__file__), "golden", "foldclass.npz"))
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    torch.save(sd, str(d / "foldclass.pt"))
    model = tfc.FoldClassNet()
    model.load_state_dict(sd)
    model.eval()
    rng = np.random.default_rng(31)

    def walk(n):
        steps = rng.normal(size=(n, 3))
        for i in range(1, n):
            steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
        steps /= np.linalg.norm(steps, axis=1, keepdims=True)
        return np.round(np.cumsum(steps * 3.8, axis=0), 3).astype(np.float32)

    qcoords = [walk(n) for n in (70, 120, 180)]
    pdbs = []
    for i, c in enumerate(qcoords):
        pdbs.append(str(d / f"query{i}.pdb"))
        with open(pdbs[-1], "w") as fh:
            for j, (x, y, zz) in enumerate(c, start=1):
                fh.write(f"ATOM  {j:5d}  CA  ALA A{j:4d}    {x:8.3f}{y:8.3f}{zz:8.3f}"
                         "  1.00  0.00\n")
            fh.write("END\n")
    qemb = embed_structures(model, qcoords)
    qemb /= np.linalg.norm(qemb, axis=1, keepdims=True)
    n_db = 3000
    emb = rng.normal(size=(n_db, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    pool = [walk(n) for n in (80, 120, 260)]
    entries = [(f"d{i:05d}", pool[i % 3], "A" * len(pool[i % 3])) for i in range(n_db)]
    for qi, (e, c) in enumerate(zip(qemb, qcoords)):
        for j, cos in enumerate((0.98, 0.93, 0.88, 0.83, 0.78)):
            row = 101 + 401 * qi + 37 * j
            u = rng.normal(size=128)
            u -= (u @ e) * e
            u /= np.linalg.norm(u)
            emb[row] = cos * e + np.sqrt(1 - cos * cos) * u
            tc = c + rng.normal(scale=0.3 * (j + 1), size=c.shape).astype(np.float32)
            entries[row] = (f"hit_q{qi}_{j}", tc, "A" * len(tc))
    codecs.write_pt_db(str(d / "db"), emb, entries)
    return d, pdbs


def _tsv_rows(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


@pytest.mark.parametrize("rerank", [False, True])
def test_cli_search_ivf_matches_jax(cli_setup, rerank):
    """`search --search_index ivf --nprobe 8 [--ivf_rerank] -d cpu`: the
    port's TSV equals the JAX CLI's (emb_score within 5e-3, every other
    field exactly). The JAX run writes the IVF cache; the port opens it."""
    from merizo_search_tpu import cli as jcli
    from merizo_search_tpu_torch import cli as tcli

    d, pdbs = cli_setup
    flags = ["-k", "5", "--output_headers", "--weights", str(d / "foldclass.pt"),
             "--search_index", "ivf", "--nprobe", "8", "--nlist", "16",
             *(["--ivf_rerank"] if rerank else [])]
    tag = "rr" if rerank else "plain"
    jcli.main(["search", *pdbs, str(d / "db"), str(d / f"jax_{tag}"), "-d", "cpu", *flags])
    tcli.main(["search", *pdbs, str(d / "db"), str(d / f"port_{tag}"), "-d", "cpu", *flags])
    j = _tsv_rows(str(d / f"jax_{tag}_search.tsv"))
    t = _tsv_rows(str(d / f"port_{tag}_search.tsv"))
    assert t[0] == j[0] and len(t) == len(j) > len(pdbs)
    col = j[0].index("emb_score")
    for a, b in zip(t[1:], j[1:]):
        assert a[:col] + a[col + 1:] == b[:col] + b[col + 1:]
        assert abs(float(a[col]) - float(b[col])) <= 5e-3
    tcol = j[0].index("target")
    assert {r[tcol] for r in t[1:]} >= {f"hit_q{i}_0" for i in range(len(pdbs))}
