"""The port's mesh modes against the JAX package's, on the CPU.

The JAX side runs on tests/conftest.py's 8 virtual CPU devices (a `Mesh`
over `jax.devices()[:n]`, Pallas in interpret mode where its own tests use
it); the port on `make_mesh(n, "cpu")`, n shards on the CPU device, each
scanning with the kernels' plain versions. Every JAX mesh test has a twin
here (tests/test_search_engine.py, test_pallas_scan.py, test_ivf.py,
test_createdb.py), on the same data made from a numpy seed, at 1, 2, 4
and 8 shards where a test says so, and with DBs whose size is not a
multiple of 128 rows a shard.

Tolerances:
- scores within 1e-5 of the JAX mesh function, index sets equal except
  among scores within 1e-5 of the k-th (ties; tests/test_torch_ivf.py's
  rule), where both packages compute one arithmetic: fp32 engines, the
  fused mesh scan in bf16 and int8 (JAX `build_mesh_search(fused=True,
  interpret=True)`), and the mesh IVF in fp32, bf16 and int8;
- where the JAX engine on the CPU runs another arithmetic than the port
  (bf16 and int8 flat or stream engines: JAX scans f32 queries, or
  dequantises int8 to f32, off the TPU), the port's mesh equals its own
  one-device engine exactly, and the JAX mesh engine within 5e-3, the
  tolerance tests/test_torch_search.py gives that difference;
- embeddings within 1e-4 (tests/test_createdb.py:82).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from merizo_search_tpu.db import codecs as jcodecs
from merizo_search_tpu.pipeline.embed import (embed_structures as jax_embed,
                                              load_foldclass_params as jax_load_params)
from merizo_search_tpu.search import ivf as jivf
from merizo_search_tpu.search.engine import SearchEngine as JEngine, build_mesh_search
from merizo_search_tpu_torch import cli as tcli
from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.device import make_mesh, resolve_mesh
from merizo_search_tpu_torch.ops.topk import quantize_blocks, quantize_rows
from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params
from merizo_search_tpu_torch.search import ivf as tivf
from merizo_search_tpu_torch.search.engine import SearchEngine, mesh_search

TOL, QTOL, EMB_TOL = 1e-5, 5e-3, 1e-4
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
SHARDS = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jmesh(n):
    devs = jax.devices()[:n]
    assert len(devs) == n, "conftest should provide 8 virtual devices"
    return Mesh(np.array(devs), ("d",))


def assert_same_topk(vt, it, vj, ij, tol):
    """Scores within tol; id sets equal except among entries within tol of
    the k-th score (ties may be broken either way)."""
    vt, vj = np.asarray(vt, np.float64), np.asarray(vj, np.float64)
    it, ij = np.asarray(it), np.asarray(ij)
    assert vt.shape == vj.shape
    np.testing.assert_allclose(vt, vj, atol=tol, rtol=0)
    for r in range(vt.shape[0]):
        last = vj[r, -1]
        assert (set(it[r][vt[r] > last + 2 * tol].tolist())
                == set(ij[r][vj[r] > last + 2 * tol].tolist()))


def assert_equal_topk(a, b):
    """One engine's result against another's: scores bit for bit, indices
    equal except among tied scores."""
    (va, ia), (vb, ib) = a, b
    np.testing.assert_array_equal(va, vb)
    for r in range(va.shape[0]):
        for v in np.unique(va[r]):
            tied = va[r] == v
            assert sorted(ia[r][tied].tolist()) == sorted(ib[r][tied].tolist())


def brute_force(q, embs, k):
    qn = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float64)
    en = (embs / np.linalg.norm(embs, axis=1, keepdims=True)).astype(np.float64)
    s = qn @ en.T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def make_db(tmp_path, rng, n, kind="pt"):
    """tests/test_search_engine.py's _make_db (the port's codecs write it,
    both packages read it)."""
    embs = rng.normal(size=(n, 128)).astype(np.float32)
    entries = []
    for i in range(n):
        ln = int(rng.integers(30, 300))
        entries.append((f"d{i:05d}", rng.normal(size=(ln, 3)).astype(np.float32), "A" * ln))
    prefix = str(tmp_path / f"db_{kind}")
    if kind == "pt":
        codecs.write_pt_db(prefix, embs, entries)
    else:
        w = codecs.MmapDBWriter(prefix, dim=128)
        for (name, ca, seq), e in zip(entries, embs):
            w.add(name, e, ca, seq)
        w.finalize()
    return prefix, embs, entries


# -- the mesh -------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 4, 8])
def test_make_mesh_on_the_cpu(n):
    mesh = make_mesh(n, "cpu")
    assert mesh is None if n == 0 else mesh == (torch.device("cpu"),) * n
    if n:
        assert resolve_mesh(mesh) == mesh


def test_make_mesh_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(2, "cuda")
    assert make_mesh(0, "cuda") is None          # no mesh asked: nothing resolved
    with pytest.raises(ValueError):
        make_mesh(-1, "cpu")
    with pytest.raises(ValueError, match="one type"):
        resolve_mesh(["cpu", "cuda:0"])


def test_make_mesh_shrinks_to_the_cards_there_are(monkeypatch, caplog):
    """--mesh 4 with one card: JAX's warning, and a mesh of that card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with caplog.at_level(logging.WARNING, logger="merizo_search_tpu_torch.device"):
        mesh = make_mesh(4, "cuda")
    assert mesh == (torch.device("cuda", 0),)
    assert "requested mesh of 4 devices but only 1 available; using 1" in caplog.text


# -- flat device mode: tests/test_search_engine.py's mesh tests -----------------

@pytest.mark.parametrize("nd", SHARDS)
def test_mesh_sharded_search(tmp_path, nd):
    """test_search_engine.py:85 at 1-8 shards: 1,000 rows (not a multiple
    of 128 rows a shard), fp32, against the JAX mesh engine and brute
    force."""
    rng = np.random.default_rng(0)
    prefix, embs, _ = make_db(tmp_path, rng, 1000)
    q = rng.normal(size=(5, 128)).astype(np.float32)
    vj, ij = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(nd), chunk=64).search(q, k=10)
    eng = SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", mesh=make_mesh(nd, "cpu"))
    vt, it = eng.search(q, k=10)
    assert_same_topk(vt, it, vj, ij, TOL)
    bv, bi = brute_force(q, embs, 10)
    assert_same_topk(vt, it, bv, bi, TOL)
    assert len(eng._shards) == nd
    assert len({sh["rows"].shape[0] for sh in eng._shards}) == 1
    assert sum(sh["rows"].shape[0] for sh in eng._shards) % (nd * 128) == 0


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_mesh_with_mincov(tmp_path, precision):
    """test_search_engine.py:98: 300 rows on 4 shards with the mincov
    channel, against the JAX mesh engine and the one-device engine."""
    rng = np.random.default_rng(1)
    prefix, _, entries = make_db(tmp_path, rng, 300)
    q = rng.normal(size=(2, 128)).astype(np.float32)
    qlen = np.asarray([100, 250])
    kw = dict(k=15, query_lens=qlen, mincov=0.7)
    vj, ij = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(4), chunk=32,
                     dtype=JDTYPE[precision]).search(q, **kw)
    db = codecs.FlatDB.open(prefix)
    got = SearchEngine(db, precision, "cpu", mesh=make_mesh(4, "cpu")).search(q, **kw)
    one = SearchEngine(db, precision, "cpu").search(q, **kw)
    assert_equal_topk(got, one)
    assert_same_topk(*got, vj, ij, TOL if precision == "fp32" else QTOL)
    lengths = np.asarray([len(e[2]) for e in entries])
    for qi in range(2):
        for v, i in zip(*[x[qi] for x in got]):
            if i >= 0 and np.isfinite(v):
                assert qlen[qi] >= lengths[i] * 0.7


@pytest.mark.parametrize("nd", SHARDS)
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_quantised_mesh_equals_one_device(tmp_path, precision, nd):
    """The fused scan on 1-8 shards of 1,000 rows equals the one-device
    engine exactly (each shard scores a row as one device does; the merge
    is exact), with and without the mincov channel."""
    rng = np.random.default_rng(2)
    prefix, _, _ = make_db(tmp_path, rng, 1000)
    db = codecs.FlatDB.open(prefix)
    q = rng.normal(size=(6, 128)).astype(np.float32)
    qlen = rng.integers(60, 300, 6)
    mesh = SearchEngine(db, precision, "cpu", mesh=make_mesh(nd, "cpu"))
    one = SearchEngine(db, precision, "cpu")
    assert_equal_topk(mesh.search(q, 20), one.search(q, 20))
    assert_equal_topk(mesh.search(q, 20, query_lens=qlen, mincov=0.7),
                      one.search(q, 20, query_lens=qlen, mincov=0.7))


def test_int8_quantized_mesh_kernel_exact():
    """test_search_engine.py:210: the quantised fused scan on a 4-shard mesh
    (JAX: interpret mode, tile 256) against the port's mesh_search on the
    same int8 rows, block scales and int8 queries."""
    rng = np.random.default_rng(3)
    n, k, nd = 4 * 256, 7, 4
    embs = rng.normal(size=(n, 128)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    q = rng.normal(size=(2, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db8, rs = quantize_blocks(embs)
    q8, qs = quantize_rows(q)
    fn = build_mesh_search(jmesh(nd), k=k, chunk=64, mincov=0.0, use_lengths=False,
                           fused=True, fused_tile=256, interpret=True, quantized=True)
    vj, ij = fn(jnp.asarray(q8), jnp.asarray(db8), jnp.zeros(n, jnp.float32),
                jnp.asarray([n], jnp.int32), jnp.zeros(2, jnp.float32), jnp.asarray(rs))
    vj = np.asarray(vj) * qs[:, None]
    r = n // nd
    shards = [{"rows": torch.from_numpy(db8[j * r:(j + 1) * r]),
               "scales": torch.from_numpy(rs[j * r:(j + 1) * r])} for j in range(nd)]
    rep = (torch.from_numpy(q8), torch.from_numpy(qs), torch.zeros(2))
    vt, it = mesh_search([rep] * nd, shards, n, k)
    assert_same_topk(vt.numpy(), it.numpy(), vj, ij, TOL)
    deq = db8.astype(np.float32) * rs[:, None]
    s = (q8.astype(np.float32) * qs[:, None]) @ deq.T
    bi = np.argsort(-s, axis=1, kind="stable")[:, :k]
    for qi in range(2):
        must = set(bi[qi][np.take_along_axis(s, bi, 1)[qi] > s[qi, bi[qi, -1]] + 1e-5])
        assert must <= set(it[qi].tolist())


@pytest.fixture(scope="module")
def problem():
    """tests/test_pallas_scan.py's problem: 8,192 unit rows, 5 queries,
    lengths 50-200."""
    rng = np.random.default_rng(4)
    db = rng.normal(size=(1 << 13, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = rng.normal(size=(5, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tlen = rng.uniform(50, 200, len(db)).astype(np.float32)
    qlen = rng.uniform(50, 200, len(q)).astype(np.float32)
    return q, db, tlen, qlen


def _row_shards(nd, rows, tlen=None, scales=None):
    r = len(rows) // nd
    return [{"rows": rows[j * r:(j + 1) * r],
             **({} if tlen is None else {"tlen": tlen[j * r:(j + 1) * r]}),
             **({} if scales is None else {"scales": scales[j * r:(j + 1) * r]})}
            for j in range(nd)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_mesh_search_exact(problem, dtype):
    """test_pallas_scan.py:113: the fused scan on an 8-shard mesh with the
    mincov channel (JAX: interpret mode, tile 512), f32 and bf16 rows, the
    port's mesh_search on the same shards."""
    q, db, tlen, qlen = problem
    n, k, nd = len(db), 17, 8
    jd = JDTYPE[dtype]
    mesh = jmesh(nd)
    fn = build_mesh_search(mesh, k=k, chunk=256, mincov=0.7, use_lengths=True,
                           fused=True, fused_tile=512, interpret=True)
    demb = jax.device_put(jnp.asarray(db).astype(jd), NamedSharding(mesh, P("d", None)))
    dlen = jax.device_put(jnp.asarray(tlen), NamedSharding(mesh, P("d")))
    vj, ij = fn(jnp.asarray(q).astype(jd), demb, dlen, jnp.asarray([n], jnp.int32),
                jnp.asarray(qlen), dlen)
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    shards = _row_shards(nd, torch.from_numpy(db).to(td), torch.from_numpy(tlen))
    rep = (torch.from_numpy(q).to(td), None, torch.from_numpy(qlen))
    vt, it = mesh_search([rep] * nd, shards, n, k, mincov=0.7, use_len=True)
    assert_same_topk(vt.numpy(), it.numpy(), np.asarray(vj), np.asarray(ij), TOL)


def test_fused_mesh_int8(problem):
    """test_pallas_scan.py:133: int8 shards with their block scales on an
    8-shard mesh: the exact top-k of the quantised scores, as JAX's."""
    q, db, _, _ = problem
    n, k, nd = len(db), 9, 8
    db8, rs = quantize_blocks(db)
    q8, _ = quantize_rows(q)
    sq = (q8.astype(np.int64) @ db8.astype(np.int64).T) * rs[None, :].astype(np.float64)
    ref_i = np.argsort(-sq, axis=1, kind="stable")[:, :k]
    mesh = jmesh(nd)
    fn = build_mesh_search(mesh, k=k, chunk=256, mincov=0.0, use_lengths=False,
                           fused=True, fused_tile=512, interpret=True, quantized=True)
    sh, sh1 = NamedSharding(mesh, P("d", None)), NamedSharding(mesh, P("d"))
    vj, ij = fn(jnp.asarray(q8), jax.device_put(jnp.asarray(db8), sh),
                jax.device_put(jnp.zeros(n, jnp.float32), sh1), jnp.asarray([n], jnp.int32),
                jnp.zeros(q.shape[0], jnp.float32), jax.device_put(jnp.asarray(rs), sh1))
    shards = _row_shards(nd, torch.from_numpy(db8), scales=torch.from_numpy(rs))
    rep = (torch.from_numpy(q8), None, torch.zeros(len(q)))
    vt, it = mesh_search([rep] * nd, shards, n, k)
    np.testing.assert_array_equal(it.numpy(), ref_i)
    assert_same_topk(vt.numpy(), it.numpy(), np.asarray(vj), np.asarray(ij), TOL)


def test_int8_sidecar_mesh_resident_unaligned_shards(tmp_path):
    """test_search_engine.py:446: an int8-sidecar DB of 200 rows on 2
    shards (the second shard holds no row): sidecar reads start on 128-row
    boundaries, and the mesh equals one device exactly."""
    rng = np.random.default_rng(5)
    prefix, embs, _ = make_db(tmp_path, rng, 200, kind="mmap")
    codecs.write_quantized_sidecar(prefix, "int8")
    db = codecs.FlatDB.open(prefix)
    assert db.has_quant("int8")
    q = rng.normal(size=(4, 128)).astype(np.float32)
    vj, ij = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(2), chunk=56,
                     dtype=jnp.int8).search(q, k=5)
    eng = SearchEngine(db, "int8", "cpu", mesh=make_mesh(2, "cpu"))
    assert eng.mode == "device"
    got = eng.search(q, k=5)
    assert_equal_topk(got, SearchEngine(db, "int8", "cpu").search(q, k=5))
    assert_same_topk(*got, vj, ij, QTOL)
    bv, bi = brute_force(q, embs, 5)
    for qi in range(4):  # int8 noise: top-5 overlap >= 4, as the JAX test asks
        assert len(set(got[1][qi].tolist()) & set(bi[qi].tolist())) >= 4


# -- stream mode ------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 4])
def test_stream_with_mesh_matches_bruteforce(tmp_path, nd):
    """test_search_engine.py:130: 900 rows streamed in superblocks of 300,
    each row-sharded over the mesh (fp32), against the JAX mesh engine and
    brute force."""
    rng = np.random.default_rng(6)
    prefix, embs, _ = make_db(tmp_path, rng, 900, kind="mmap")
    q = rng.normal(size=(3, 128)).astype(np.float32)
    je = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(nd), chunk=32, max_device_gb=1e-9)
    je.stream_block = 300
    vj, ij = je.search(q, k=11)
    eng = SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", mesh=make_mesh(nd, "cpu"),
                       max_device_gb=1e-9, stream_block=300)
    assert eng.mode == "stream"
    vt, it = eng.search(q, k=11)
    assert eng.stream_stats["superblocks"] == 3
    assert_same_topk(vt, it, vj, ij, TOL)
    bv, bi = brute_force(q, embs, 11)
    assert_same_topk(vt, it, bv, bi, TOL)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_int8_mesh_stream_engine(tmp_path, precision):
    """test_search_engine.py:194: bf16 / int8 + mesh + stream (the TED
    production configuration): equal to the port's one-device device mode
    exactly, near the JAX mesh stream engine and brute force."""
    rng = np.random.default_rng(7)
    prefix, embs, _ = make_db(tmp_path, rng, 800, kind="mmap")
    q = rng.normal(size=(3, 128)).astype(np.float32)
    vj, ij = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(4), chunk=32,
                     dtype=JDTYPE[precision], max_device_gb=1e-9).search(q, k=9)
    db = codecs.FlatDB.open(prefix)
    eng = SearchEngine(db, precision, "cpu", mesh=make_mesh(4, "cpu"), max_device_gb=1e-9,
                       stream_block=300)
    assert eng.mode == "stream"
    got = eng.search(q, k=9)
    assert_equal_topk(got, SearchEngine(db, precision, "cpu").search(q, k=9))
    assert_same_topk(*got, vj, ij, QTOL)
    bv, bi = brute_force(q, embs, 9)
    np.testing.assert_allclose(got[0], bv, atol=0.01)


def test_mesh_device_budget_scales_with_the_devices(tmp_path):
    """The device budget is max_device_gb a device: a DB over one device's
    budget stays resident on a mesh that holds it (JAX engine.py:193-197)."""
    rng = np.random.default_rng(8)
    prefix, _, _ = make_db(tmp_path, rng, 1000)
    db = codecs.FlatDB.open(prefix)
    gb = 1000 * 128 * 2 / 2 ** 30 / 3              # a third of the bf16 DB
    assert SearchEngine(db, "bf16", "cpu", max_device_gb=gb).mode == "stream"
    assert SearchEngine(db, "bf16", "cpu", max_device_gb=gb,
                        mesh=make_mesh(2, "cpu")).mode == "stream"
    assert SearchEngine(db, "bf16", "cpu", max_device_gb=gb,
                        mesh=make_mesh(4, "cpu")).mode == "device"


# -- IVF: tests/test_ivf.py's mesh tests ------------------------------------------

@pytest.fixture(scope="module")
def mixture():
    """tests/test_ivf.py's mixture (its own default_rng(1234))."""
    rng = np.random.default_rng(1234)
    n, d = 1 << 13, 128
    centers = rng.normal(size=(32, d)).astype(np.float32) * 3
    emb = centers[rng.integers(0, 32, n)] + rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.choice(n, 8, replace=False)].copy()
    q += rng.normal(size=q.shape).astype(np.float32) * 0.02
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


@pytest.fixture(scope="module")
def layout(mixture):
    """The JAX build both packages search (multiple_of=8: shards at 1-8)."""
    ivf = jivf.build_ivf(mixture[0], nlist=64, seed=1, multiple_of=8)
    assert ivf["nlist"] == 64 and ivf["dup"]
    return ivf


@pytest.mark.parametrize("nd", SHARDS)
def test_mesh_ivf_matches_single_device(mixture, layout, nd):
    """test_ivf.py:244 at 1-8 shards: JAX build_mesh_ivf_search (f32,
    interpret) against the port's mesh_ivf_search on resident_layout
    shards of the same build, and against the port's one-device
    ivf_search."""
    emb, q = mixture
    k, nprobe = 10, 8
    ivf, perm = layout, layout["perm"]
    dbp = jivf.permute_db(emb, ivf)
    mesh = jmesh(nd)
    fn = jivf.build_mesh_ivf_search(mesh, k, nprobe, use_len=False, mincov=0.0,
                                    interpret=True, dedup=True)
    tl = jnp.zeros(len(perm), jnp.float32)
    sh, sh1 = NamedSharding(mesh, P("d", None)), NamedSharding(mesh, P("d"))
    dbp_sh = jax.device_put(dbp, sh)
    vj, ij = fn(jnp.asarray(q), jnp.asarray(q), dbp_sh, jnp.asarray(ivf["centroids"]),
                jax.device_put(tl, sh1), jax.device_put(perm, sh1),
                jnp.zeros(len(q), jnp.float32), jax.device_put(tl, sh1), dbp_sh)
    r = len(perm) // nd
    shards = [tivf.resident_layout(emb, ivf, torch.float32, "cpu", rows=(j * r, (j + 1) * r))
              for j in range(nd)]
    vt, it = tivf.mesh_ivf_search(shards, torch.from_numpy(q), k, nprobe)
    assert_same_topk(vt.numpy(), it.numpy(), np.asarray(vj), np.asarray(ij), TOL)
    one = tivf.resident_layout(emb, ivf, torch.float32, "cpu")
    v1, i1 = tivf.ivf_search(torch.from_numpy(q), one["db"], one["centroids"], one["perm"],
                             k, nprobe, dedup=True)
    assert_equal_topk((vt.numpy(), it.numpy()), (v1.numpy(), i1.numpy()))


def test_probe_blocks_remaps_to_the_local_shard(mixture, layout):
    """_probe_blocks with nlist_local/me: the local clusters' blocks, -1 for
    every probe of another shard's cluster; the shards' ids together are
    the one-device probe."""
    emb, q = mixture
    cent = torch.from_numpy(layout["centroids"])
    qt = torch.from_numpy(q)
    bpc = layout["cluster_rows"] // 128
    full = tivf._probe_blocks(qt, cent, 8, bpc)
    got = torch.full_like(full, -1)
    for me in range(4):
        loc = tivf._probe_blocks(qt, cent, 8, bpc, nlist_local=16, me=me)
        assert ((loc == -1) | ((loc >= 0) & (loc < 16 * bpc))).all()
        got = torch.where(loc >= 0, loc + me * 16 * bpc, got)
    assert torch.equal(got, full)


def _ivf_db(tmp_path, emb, name):
    rng = np.random.default_rng(5)
    entries = [(f"d{i}", np.zeros((int(n), 3), np.float32), "A" * int(n))
               for i, n in enumerate(rng.integers(30, 300, len(emb)))]
    prefix = str(tmp_path / name)
    codecs.write_pt_db(prefix, emb, entries)
    return prefix


def test_engine_mesh_ivf_rerank(tmp_path, mixture):
    """test_ivf.py:215: the reranked IVF on an 8-shard mesh (fp32): the JAX
    mesh engine's hits over the one cached layout, recall > 0.9 and exact
    f32 values, as the JAX test asks."""
    emb, q = mixture
    prefix = _ivf_db(tmp_path, emb, "db")
    kw = dict(index="ivf", ivf_nlist=64, ivf_nprobe=16, ivf_rerank=True)
    vj, ij = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(8), **kw).search(q, k=5)
    eng = SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", mesh=make_mesh(8, "cpu"),
                       **kw)
    vals, idxs = eng.search(q, k=5)
    assert eng.ivf_build_s is None                      # JAX's cached build
    assert_same_topk(vals, idxs, vj, ij, TOL)
    s = q @ emb.T
    ref = np.argsort(-s, axis=1)[:, :5]
    assert np.mean([len(set(idxs[r]) & set(ref[r])) / 5 for r in range(len(q))]) > 0.9
    np.testing.assert_allclose(vals, np.take_along_axis(s, idxs, axis=1), atol=2e-5)


@pytest.mark.parametrize("precision,rerank", [("fp32", False), ("bf16", False),
                                              ("bf16", True), ("int8", False),
                                              ("int8", True)])
def test_engine_mesh_ivf(tmp_path, mixture, precision, rerank):
    """test_ivf.py:278 and :328: the IVF engine on a 4-shard mesh (fp32,
    bf16, int8; the build's duplicates, so the cross-shard dedup) against
    the JAX mesh engine over one cached layout (fp32 and int8; bf16
    without rerank), and equal to the port's one-device engine exactly.
    JAX's mesh probes the f32 query when reranking, its one device the
    bf16 one; the port probes as its one device does (ROADMAP.md queue 3),
    so the bf16 rerank is held to the port's one device alone."""
    emb, q = mixture
    prefix = _ivf_db(tmp_path, emb, f"db_{precision}")
    kw = dict(index="ivf", ivf_nlist=64, ivf_nprobe=8, ivf_rerank=rerank)
    qlen = np.full(len(q), 150, np.int32)     # mincov 0.7 drops targets over 214 residues
    search = dict(k=10, query_lens=qlen, mincov=0.7)
    je = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(4), dtype=JDTYPE[precision], **kw)
    vj, ij = je.search(q, **search)
    db = codecs.FlatDB.open(prefix)
    eng = SearchEngine(db, precision, "cpu", mesh=make_mesh(4, "cpu"), **kw)
    got = eng.search(q, **search)
    assert eng.ivf_build_s is None
    assert_equal_topk(got, SearchEngine(db, precision, "cpu", **kw).search(q, **search))
    if not (precision == "bf16" and rerank):
        assert_same_topk(*got, vj, ij, TOL)
    for r in range(len(q)):
        ids = got[1][r][got[1][r] >= 0].tolist()
        assert len(set(ids)) == len(ids)            # deduplicated across shards


def test_cached_layout_of_another_mesh_is_rebuilt(tmp_path, monkeypatch, mixture):
    """A cached layout whose nlist the mesh does not divide (a one-device
    build clamped to 6 clusters) is built again for 4 shards and not
    cached, as JAX does (engine.py:298-302); both packages then search
    one build (the port's build_ivf swapped for JAX's, so the layouts are
    the same) and agree."""
    emb, q = mixture
    emb = emb[:700]                      # cap = ceil(700 / 128) = 6 clusters
    prefix = _ivf_db(tmp_path, emb, "db")
    kw = dict(index="ivf", ivf_nlist=8, ivf_nprobe=4)
    monkeypatch.setattr(tivf, "build_ivf",
                        lambda emb, nlist, multiple_of=1, device=None, **a:
                        jivf.build_ivf(emb, nlist, multiple_of=multiple_of, **a))
    one = SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", **kw)
    one.search(q, 5)
    assert one.ivf_nlist == 6 and os.path.exists(prefix + ".ivf8.npz")
    before = os.stat(prefix + ".ivf8.npz").st_mtime_ns
    eng = SearchEngine(codecs.FlatDB.open(prefix), "fp32", "cpu", mesh=make_mesh(4, "cpu"),
                       **kw)
    got = eng.search(q, 5)
    assert eng.ivf_nlist == 4 and eng.ivf_build_s is not None
    assert os.stat(prefix + ".ivf8.npz").st_mtime_ns == before
    vj, ij = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(4), **kw).search(q, k=5)
    assert_same_topk(*got, vj, ij, TOL)


# -- stream IVF -------------------------------------------------------------------

def _clustered_db(tmp_path, rng, n=1024, ncent=8):
    cent = rng.normal(size=(ncent, 128)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    a = rng.integers(0, ncent, n)
    embs = (cent[a] + 0.15 * rng.normal(size=(n, 128))).astype(np.float32)
    prefix = str(tmp_path / "db_clustered")
    w = codecs.MmapDBWriter(prefix, dim=128)
    for i in range(n):
        ln = int(rng.integers(30, 300))
        w.add(f"d{i:05d}", embs[i], rng.normal(size=(ln, 3)).astype(np.float32), "A" * ln)
    w.finalize()
    return prefix, embs


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_stream_ivf_with_mesh(tmp_path, precision):
    """test_search_engine.py:387: disk-streaming IVF with each staged group
    row-sharded over 4 shards, on one sidecar set (JAX's): fp32 against
    the JAX mesh engine and brute force; every precision equal to the
    port's one-device stream IVF exactly."""
    rng = np.random.default_rng(9)
    prefix, embs = _clustered_db(tmp_path, rng)
    kw = dict(max_device_gb=1e-9, stream_block=512, index="ivf", ivf_nlist=8, ivf_nprobe=8)
    q = rng.normal(size=(6, 128)).astype(np.float32)
    qlen = np.full(len(q), 200, np.int32)
    search = dict(k=10, query_lens=qlen, mincov=0.7)
    je = JEngine(jcodecs.FlatDB.open(prefix), mesh=jmesh(4), chunk=64,
                 dtype=JDTYPE[precision], **kw)
    vj, ij = je.search(q, **search)
    db = codecs.FlatDB.open(prefix)
    eng = SearchEngine(db, precision, "cpu", mesh=make_mesh(4, "cpu"), **kw)
    assert eng.mode == "stream"
    got = eng.search(q, **search)
    assert eng.ivf_build_s is None and eng.stream_stats["groups"] >= 2
    assert_equal_topk(got, SearchEngine(db, precision, "cpu", **kw).search(q, **search))
    assert_same_topk(*got, vj, ij, TOL if precision == "fp32" else QTOL)
    if precision == "fp32":
        vals, idxs = SearchEngine(db, "fp32", "cpu", mesh=make_mesh(4, "cpu"),
                                  **kw).search(q, k=10)
        bv, bi = brute_force(q, embs, 10)
        assert_same_topk(vals, idxs, bv, bi, TOL)


# -- the data-parallel embed --------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return jax_load_params(None), load_foldclass_params(None, "cpu")


@pytest.mark.parametrize("nd", [1, 4, 8])
def test_embed_mesh_data_parallel(models, nd):
    """test_createdb.py:72: the embed data parallel over a mesh (an uneven
    count of structures against the shards) equals the JAX mesh embed and
    the port's one-device embed within 1e-4; one replica a distinct device
    (the CPU's: the model itself)."""
    jparams, model = models
    rng = np.random.default_rng(10)
    sizes = [40, 40, 40, 64, 64, 100, 100]
    cl = [(rng.normal(size=(s, 3)) * 8).astype(np.float32) for s in sizes]
    got = embed_structures(model, cl, mesh=make_mesh(nd, "cpu"))
    np.testing.assert_allclose(got, jax_embed(jparams, cl, mesh=jmesh(nd)), atol=EMB_TOL)
    np.testing.assert_allclose(got, embed_structures(model, cl), atol=EMB_TOL)
    assert not getattr(model, "mesh_replicas", {})


def test_embed_mesh_batches_a_multiple_of_the_shards(models, monkeypatch):
    """Each batch is padded with masked rows to a multiple of the shards, and
    each shard embeds an equal slice (batch budget 3 on 2 shards: slices
    of 2 rows, one of them padding in the last batch)."""
    from merizo_search_tpu_torch.models import foldclass as tfc

    _, model = models
    rng = np.random.default_rng(11)
    cl = [(rng.normal(size=(50, 3)) * 8).astype(np.float32) for _ in range(7)]
    seen = []
    orig = tfc.FoldClassNet.forward

    def spy(self, coords, mask=None):
        seen.append((coords.shape[0], int(mask.sum(dim=1).gt(0).sum())))
        return orig(self, coords, mask)

    monkeypatch.setattr(tfc.FoldClassNet, "forward", spy)
    got = embed_structures(model, cl, batch_budget=lambda b: 3, mesh=make_mesh(2, "cpu"))
    assert seen == [(2, 2), (2, 2), (2, 2), (2, 1)]
    np.testing.assert_allclose(got, embed_structures(model, cl), atol=EMB_TOL)


# -- the CLI ------------------------------------------------------------------------

def _write_pdb(path, coords):
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords, start=1):
            fh.write(f"ATOM  {i:5d}  CA  ALA A{i:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
        fh.write("END\n")


def _walk(rng, n):
    steps = rng.normal(size=(n, 3))
    for i in range(1, n):
        steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(steps * 3.8, axis=0).astype(np.float32)


def test_createdb_mesh_cli(tmp_path):
    """`createdb --mesh 3 -d cpu` writes the DB `createdb` does: the same
    entries, embeddings within 1e-4."""
    rng = np.random.default_rng(12)
    d = tmp_path / "pdbs"
    d.mkdir()
    for i, n in enumerate(rng.integers(40, 200, 7)):
        _write_pdb(str(d / f"c{i}.pdb"), _walk(rng, int(n)))
    for tag, extra in (("one", []), ("mesh", ["--mesh", "3"])):
        tcli.main(["createdb", str(d), str(tmp_path / tag / "db"), "-d", "cpu",
                   "--db_format", "mmap", *extra])
    a = codecs.FlatDB.open(str(tmp_path / "one" / "db"))
    b = codecs.FlatDB.open(str(tmp_path / "mesh" / "db"))
    assert a.size == b.size == 7
    assert [a.name(i) for i in range(7)] == [b.name(i) for i in range(7)]
    np.testing.assert_allclose(np.asarray(a.embeddings()), np.asarray(b.embeddings()),
                               atol=EMB_TOL)
