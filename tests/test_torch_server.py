"""The port's search server (server.py) and the device aligner through the
CLI, on the CPU.

The port's twins of tests/test_server.py's cases run the port's HTTP server
in a background thread over a small synthetic DB and drive /healthz,
/search and /stats through a real HTTP client; the MicroBatcher cases run
as in the JAX test. Then:

- parity with the JAX package's SearchService on one `.pt` DB built with
  the default Foldclass weights (the same init in both packages): the same
  targets in the same order, emb_score within 1e-4 (the embedders agree to
  ~1e-6 and the JSON rounds to 4 decimals), TM-scores within 1e-6 (both
  packages build the same native C++ TM-align);
- a service with tmalign_backend="tpu" (the device aligner, here on the
  CPU) answering /search;
- a warm-up that fails ends the boot (the JAX server logs and serves on);
- the `serve` verb's flags and defaults, and --mesh rejected;
- `search --tmalign_backend tpu -d cpu` and `easy-search
  --multi_domain_search --tmalign_backend tpu -d cpu` run through the
  device aligner.
"""

import glob
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch import cli as tcli
from merizo_search_tpu_torch import server as srv
from merizo_search_tpu_torch.align import tmalign as ttm
from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.ops import blockmax
from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params

EMB_TOL = 1e-4
TM_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _db(tmp, seed, n):
    """A .pt DB of n random walks of 60 + 10 i residues, default weights."""
    rng = np.random.default_rng(seed)
    coords = [np.cumsum(rng.normal(size=(60 + 10 * i, 3)) * 1.8, axis=0).astype(np.float32)
              for i in range(n)]
    embs = embed_structures(load_foldclass_params(None, "cpu"), coords)
    prefix = str(tmp / "db")
    codecs.write_pt_db(prefix, embs, [(f"t{i}", c, "A" * len(c)) for i, c in enumerate(coords)])
    return prefix, coords


def _start(service):
    httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def running_server(tmp_path_factory):
    prefix, coords = _db(tmp_path_factory.mktemp("srvdb"), 0, 5)
    service = srv.SearchService(prefix, precision="fp32", device="cpu")
    httpd, base = _start(service)
    yield base, coords, prefix
    httpd.shutdown()
    httpd.server_close()


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def _get(base, path):
    with urllib.request.urlopen(base + path) as resp:
        return json.loads(resp.read())


def _status(base, path, data, **headers):
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json", **headers})
    try:
        urllib.request.urlopen(req)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_healthz(running_server):
    base, _, _ = running_server
    h = _get(base, "/healthz")
    assert h == {"status": "ok", "db_size": 5, "mode": "device"}


def test_search_self_hit(running_server):
    base, coords, _ = running_server
    r = _post(base, "/search", {"coords": coords[2].tolist(), "seq": "A" * len(coords[2]),
                                "k": 3, "mincos": 0.2, "mintm": 0.3})
    assert r["hits"], "self query must hit"
    top = r["hits"][0]
    assert top["target"] == "t2" and top["emb_score"] > 0.99 and top["q_tm"] > 0.99
    assert set(top) == {"rank", "target", "emb_score", "q_len", "t_len", "ali_len", "seq_id",
                        "q_tm", "t_tm", "rmsd", "metadata"}


def test_search_skip_tmalign(running_server):
    base, coords, _ = running_server
    r = _post(base, "/search", {"coords": coords[0].tolist(), "k": 2, "mincos": 0.0,
                                "skip_tmalign": True})
    assert len(r["hits"]) >= 1
    assert r["hits"][0]["q_tm"] is None


def test_bad_request(running_server):
    base, _, _ = running_server
    assert _status(base, "/search", b"{}") == 400
    assert _status(base, "/search", b"not json") == 400
    assert _status(base, "/easy-search", b"{}") == 400
    assert _status(base, "/nowhere", b"{}") == 404


def test_stats(running_server):
    base, _, _ = running_server
    s = _get(base, "/stats")
    assert s["db_size"] == 5 and s["mode"] == "device"
    assert s["requests"] >= 2
    assert "db_scan" in s["phase_timings"]
    search = s["phase_timings"]["search"]
    assert search["calls"] >= 1 and 0 <= search["self_seconds"] <= search["seconds"]
    assert s["counters"][blockmax.LAUNCHES] == 0    # plain runs on the CPU launch nothing


@pytest.fixture(scope="module")
def service_db(tmp_path_factory):
    return _db(tmp_path_factory.mktemp("batchdb"), 1, 6)


def test_concurrent_searches_microbatch(service_db):
    """Concurrent /search requests with identical options coalesce into
    fewer engine dispatches and return exactly the per-query results a
    serial run would."""
    prefix, coords_list = service_db
    svc = srv.SearchService(prefix, precision="fp32", max_batch=8, batch_window_ms=50.0,
                            device="cpu")
    bodies = [{"coords": c.tolist(), "k": 3, "skip_tmalign": True} for c in coords_list]
    serial = [svc.search(dict(b)) for b in bodies]
    base_batches = svc.n_batches

    results = [None] * len(bodies)

    def worker(i):
        results[i] = svc.search(dict(bodies[i]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert results == serial
    assert svc.n_batches - base_batches < len(bodies)   # coalesced
    assert svc.n_requests == 2 * len(bodies)


def test_microbatcher_minority_key_not_starved_and_per_query_retry():
    """An options-mismatched request seeds the next batch (it is not
    re-queued behind newer arrivals), and one failing query does not fail
    its co-batched travellers."""
    calls = []

    def fn(key, items):
        calls.append((key, list(items)))
        if any(i == "bad" for i in items):
            if len(items) > 1:
                raise RuntimeError("batch poisoned")
            raise ValueError("bad item")
        return [f"{key}:{i}" for i in items]

    mb = srv.MicroBatcher(fn, max_batch=8, linger_ms=30.0)
    futs = [mb.submit("A", 1), mb.submit("A", 2), mb.submit("B", 9), mb.submit("A", 3)]
    assert futs[2].result(timeout=5) == "B:9"
    assert [f.result(timeout=5) for f in (futs[0], futs[1], futs[3])] == ["A:1", "A:2", "A:3"]

    f_ok = mb.submit("C", "good")
    f_bad = mb.submit("C", "bad")
    time.sleep(0.01)
    f_ok2 = mb.submit("C", "good2")
    assert f_ok.result(timeout=5) == "C:good"
    assert f_ok2.result(timeout=5) == "C:good2"
    with pytest.raises(ValueError):
        f_bad.result(timeout=5)


def test_microbatcher_under_thread_switching():
    """More submitters than cores with a tiny switch interval: every future
    gets its own item's result, every item runs in exactly one batch, and
    no batch mixes option keys."""
    import os
    import sys

    seen, lock = [], threading.Lock()

    def fn(key, items):
        with lock:
            seen.append((key, list(items)))
        return [(key, i) for i in items]

    mb = srv.MicroBatcher(fn, max_batch=16, linger_ms=1.0)
    n_threads, per = 4 * (os.cpu_count() or 2), 25
    out = {}

    def submitter(t):
        futs = [(t, j, mb.submit(j % 3, (t, j))) for j in range(per)]
        for t_, j, f in futs:
            out[(t_, j)] = f.result(timeout=60)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert out == {(t, j): (j % 3, (t, j)) for t in range(n_threads) for j in range(per)}
    ran = [i for _, items in seen for i in items]
    assert sorted(ran) == sorted(out)
    assert all(len(items) <= 16 and all(i[1] % 3 == key for i in items) for key, items in seen)


def test_strict_option_types(running_server):
    base, coords, _ = running_server
    q = {"coords": coords[0].tolist(), "seq": "A" * len(coords[0])}
    for bad in ({"skip_tmalign": "false"}, {"mincos": [0.5]}, {"mintm": "0.5"},
                {"mincov": 2.0}, {"k": 0}, {"k": "x"}, {"coords": [[1.0, 2.0]]}):
        assert _status(base, "/search", json.dumps({**q, **bad}).encode()) == 400, bad


def test_oversized_body_rejected_before_read(running_server):
    base, _, _ = running_server
    try:   # lie about the length: rejected on the header, not buffered
        code = _status(base, "/search", b"{}", **{"Content-Length": str(100 * 1024 * 1024)})
    except (ConnectionError, urllib.error.URLError):
        return    # the server may cut the connection after replying
    assert code == 413


def test_matches_the_jax_service(running_server, monkeypatch):
    """Both services on one DB: the same hits in the same order."""
    from merizo_search_tpu import server as jsrv
    from merizo_search_tpu.models.merizo import network as jnet

    _, coords, prefix = running_server
    monkeypatch.setattr(jnet, "load_merizo_params", lambda *a, **k: None)
    monkeypatch.setattr(jsrv.SearchService, "_warmup", lambda self: None)
    jsvc = jsrv.SearchService(prefix, precision="fp32", max_batch=1)
    tsvc = srv.SearchService(prefix, precision="fp32", max_batch=1, device="cpu")
    for i, skip in ((1, False), (3, False), (4, True)):
        body = {"coords": coords[i].tolist(), "k": 4, "mincos": 0.0, "mintm": 0.2,
                "mincov": 0.0, "skip_tmalign": skip}
        want, got = jsvc.search(dict(body))["hits"], tsvc.search(dict(body))["hits"]
        assert [h["target"] for h in got] == [h["target"] for h in want]
        assert [h["rank"] for h in got] == [h["rank"] for h in want]
        assert got[0]["target"] == f"t{i}"
        for g, w in zip(got, want):
            assert abs(g["emb_score"] - w["emb_score"]) <= EMB_TOL
            for key in ("q_tm", "t_tm"):
                assert (g[key] is None) == skip and (w[key] is None) == skip
                if not skip:
                    assert abs(g[key] - w[key]) <= TM_TOL
            assert g["ali_len"] == w["ali_len"]


@pytest.fixture
def aligner_calls(monkeypatch):
    calls = []
    real = ttm.tmalign_pairs

    def counted(pairs, fast=False, device="cuda"):
        calls.append(len(pairs))
        return real(pairs, fast=fast, device=device)

    monkeypatch.setattr(ttm, "tmalign_pairs", counted)
    return calls


def test_device_aligner_through_search(running_server, aligner_calls):
    _, coords, prefix = running_server
    svc = srv.SearchService(prefix, precision="fp32", tmalign_backend="tpu", device="cpu")
    assert aligner_calls == [1]        # the warm-up aligns one pair on the device
    httpd, base = _start(svc)
    try:
        r = _post(base, "/search", {"coords": coords[3].tolist(), "k": 2, "mincos": 0.2,
                                    "mintm": 0.3})
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert aligner_calls == [1, 2]
    assert r["hits"][0]["target"] == "t3" and r["hits"][0]["q_tm"] > 0.99


def test_warmup_failure_fails_the_boot(running_server, monkeypatch):
    from merizo_search_tpu_torch.segment import pipeline as seg

    def broken(*a, **k):
        raise RuntimeError("segmenter kernel failed")

    monkeypatch.setattr(seg, "segment_structure", broken)
    with pytest.raises(RuntimeError, match="segmenter kernel failed"):
        srv.SearchService(running_server[2], precision="fp32", device="cpu")


def test_serve_verb_flags_and_defaults(monkeypatch):
    seen = []
    monkeypatch.setattr(srv, "serve", lambda db, **kw: seen.append((db, kw)))
    tcli.main(["serve", "some_db"])
    assert seen.pop() == ("some_db", dict(
        host="127.0.0.1", port=8086, precision="bf16", weights=None, merizo_weights=None,
        tmalign_backend="auto", search_index="flat", nprobe=32, nlist=0, ivf_rerank=False,
        max_batch=64, batch_window_ms=4.0, device="cuda", mesh=None))
    tcli.main(["serve", "db2", "-d", "cpu", "--port", "0", "--precision", "int8",
               "--tmalign_backend", "tpu", "--search_index", "ivf", "--nprobe", "8",
               "--ivf_rerank", "--max_batch", "1", "--batch_window_ms", "2.5"])
    _, kw = seen.pop()
    assert (kw["device"], kw["port"], kw["precision"], kw["tmalign_backend"],
            kw["search_index"], kw["nprobe"], kw["ivf_rerank"], kw["max_batch"],
            kw["batch_window_ms"]) == ("cpu", 0, "int8", "tpu", "ivf", 8, True, 1, 2.5)
    tcli.main(["serve", "db3", "--mesh", "2", "-d", "cpu"])   # the DB on two CPU shards
    db, kw = seen.pop()
    assert (db, kw["device"], kw["mesh"]) == ("db3", "cpu", (torch.device("cpu"),) * 2)
    assert seen == []


def _write_ca_pdb(path, coords):
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords, start=1):
            fh.write(f"ATOM  {i:5d}  CA  ALA A{i:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
        fh.write("END\n")


def test_search_cli_with_the_device_aligner(running_server, tmp_path, aligner_calls):
    _, coords, prefix = running_server
    pdbs = []
    for i in (0, 4):
        pdbs.append(str(tmp_path / f"q{i}.pdb"))
        _write_ca_pdb(pdbs[-1], np.round(coords[i], 3))
    out = str(tmp_path / "res")
    tcli.main(["search", *pdbs, prefix, out, "-d", "cpu", "-k", "3", "--mintm", "0.3",
               "--tmalign_backend", "tpu", "--output_headers"])
    assert aligner_calls and sum(aligner_calls) >= 2
    with open(out + "_search.tsv") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [dict(zip(header, ln.rstrip("\n").split("\t"))) for ln in fh]
    first = {}
    for r in rows:
        first.setdefault(r["query"], r)
    assert {q: r["target"] for q, r in first.items()} == {"q0": "t0", "q4": "t4"}
    assert all(float(r["max_tm"]) > 0.99 for r in first.values())


def test_easy_search_multi_domain_with_the_device_aligner(tmp_path, aligner_calls):
    """A helical chain, a DB of the domains the port's segmenter cuts out of
    it, and easy-search --multi_domain_search through the device aligner:
    every domain is its own first hit and the chain its own category-3
    multi-domain match."""
    from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

    rng = np.random.default_rng(3)       # two domains with the default weights
    chain = str(tmp_path / "mdc.pdb")
    write_backbone_pdb(chain, helical_backbone(rng, 200, domain_len=(80, 100)), rng)
    tcli.main(["segment", chain, str(tmp_path / "seg" / "s"), "-d", "cpu", "--save_domains",
               "--merizo_output", str(tmp_path / "seg")])
    (tmp_path / "dbin").mkdir()
    for f in sorted(glob.glob(str(tmp_path / "seg" / "*.dom_pdb"))):
        shutil.copy(f, str(tmp_path / "dbin" / (os.path.basename(f)[:-len(".dom_pdb")] + ".pdb")))
    assert len(os.listdir(tmp_path / "dbin")) >= 2
    db = str(tmp_path / "db")
    tcli.main(["createdb", str(tmp_path / "dbin"), db, "-d", "cpu"])
    out = str(tmp_path / "es")
    tcli.main(["easy-search", chain, db, out, "-d", "cpu", "-k", "2", "--mintm", "0.9",
               "--multi_domain_search", "--tmalign_backend", "tpu", "--output_headers",
               "--merizo_output", str(tmp_path / "es_out")])
    assert len(aligner_calls) >= 2        # the search's rescore and the multi-domain pairs
    with open(out + "_search.tsv") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [dict(zip(header, ln.rstrip("\n").split("\t"))) for ln in fh]
    first = {}
    for r in rows:
        first.setdefault(r["query"], r)
    assert len(first) >= 2
    assert all(r["target"] == q and float(r["max_tm"]) > 0.99 for q, r in first.items())
    with open(out + "_search_multi_dom.tsv") as fh:
        md = [ln.rstrip("\n").split("\t") for ln in fh][1:]
    assert md and any(row[4] == "3" for row in md)
