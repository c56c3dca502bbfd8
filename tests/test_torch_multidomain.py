"""The port's multi-domain search against the JAX package's.

The cases of tests/test_multidomain.py run against both modules as
parametrised cases: each asserts what the JAX test asserts, and that the
port's twin returns exactly what the JAX module returns on the same input.
Then `multi_domain_search` end to end on one chain-ordered DB in both
modes: rows (chains, domain counts, categories, the matched domains and
metadata) equal; TM-scores equal as printed (both packages build the same
C++ TM-align source); embedding cosines within 1e-4 (the two embedders
agree to ~1e-6).
"""

from itertools import permutations, product

import numpy as np
import pytest
import torch

from merizo_search_tpu.pipeline import multidomain as jmd
from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.pipeline import multidomain as tmd

COS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,want", [
    ("cath-dompdb/2pi4A04.pdb", "2pi4A"), ("AF-Q12345-F1_TED02.pdb", "AF-Q12345-F1"),
    ("plainname.pdb", "plainname"), ("chain_merizo_03.cif", "chain_merizo"),
    ("x/1abcA00.ent.gz", "1abcA")])
def test_domid2chainid(name, want):
    assert tmd.domid2chainid(name) == jmd.domid2chainid(name) == want


def _cat(md, mtx):
    nqd = mtx.shape[0]
    hds = [{"hd": f"h{j:02d}", "hm": "{ }"} for j in range(mtx.shape[1])]
    return md._submatrix_to_hits(mtx, "qc", "hc", [f"q{i}" for i in range(nqd)], hds)


@pytest.mark.parametrize("mtx,cats", [
    ([[0.9, 0.0], [0.0, 0.8]], [3]),                          # exact MDA match
    ([[0.0, 0.9, 0.0, 0.0], [0.0, 0.0, 0.8, 0.0]], [2]),      # contiguous sub-range
    ([[0.9, 0.0, 0.0], [0.0, 0.0, 0.8]], [1]),                # ordered with gaps
    ([[0.0, 0.9], [0.8, 0.0]], [0]),                          # unordered
    ([[0.9, 0.0], [0.0, 0.0]], []),                           # a query domain unmatched
    ([[0.9, 0.0], [0.8, 0.0]], []),                           # a hit domain used twice
    ([[0.9, 0.7], [0.6, 0.8]], [3, 0]),                       # both orders of one chain
])
def test_match_categories(mtx, cats):
    mtx = np.asarray(mtx)
    got = _cat(tmd, mtx)
    assert got == _cat(jmd, mtx)
    if len(cats) == 1 or not cats:
        assert [r[4] for r in got] == cats
    else:
        assert sorted(r[4] for r in got) == sorted(cats)


@pytest.mark.parametrize("cap", [2000, 500])
def test_dense_matrix_enumeration_is_bounded(monkeypatch, cap):
    nqd, nhd = 8, 12
    rng = np.random.default_rng(7)
    mtx = rng.uniform(0.5, 0.7, size=(nqd, nhd))
    for i in range(nqd):
        mtx[i, i] = 0.95
    monkeypatch.setattr(tmd, "MAX_ASSIGNMENT_PATHS", cap)
    monkeypatch.setattr(jmd, "MAX_ASSIGNMENT_PATHS", cap)
    res = _cat(tmd, mtx)
    assert res == _cat(jmd, mtx)
    assert 0 < len(res) <= cap
    for r in res:
        cols = [f.split(":")[1] for f in r[5].split(",")]
        assert len(set(cols)) == nqd            # injective assignments only
    assert [f.split(":")[1] for f in res[0][5].split(",")] == [f"h{j:02d}" for j in range(nqd)]
    assert res[0][4] == 2


@pytest.mark.parametrize("beam", [1, 2, 4, 6])
def test_beam_paths_injective_and_ranked(beam):
    mtx = np.array([[0.9, 0.2, 0.1], [0.8, 0.7, 0.1], [0.1, 0.2, 0.6]])
    hd = [[0, 1, 2]] * 3
    paths = tmd._beam_paths(hd, mtx, beam=beam)
    assert paths == jmd._beam_paths(hd, mtx, beam=beam)
    assert all(len(set(p)) == 3 for p in paths)
    scores = [sum(mtx[i, j] for i, j in enumerate(p)) for p in paths]
    assert scores == sorted(scores, reverse=True)
    assert paths[0] == [0, 1, 2]


@pytest.mark.parametrize("trial", range(8))
def test_beam_keeps_exhaustive_ranking(trial):
    rng = np.random.default_rng(11 + trial)
    nqd, nhd = rng.integers(3, 6), rng.integers(4, 7)
    mtx = rng.uniform(0.05, 1.0, size=(nqd, nhd))
    hd = [list(range(nhd))] * nqd
    exhaustive = sorted((p for p in product(*hd) if len(set(p)) == nqd),
                        key=lambda p: -sum(mtx[i, j] for i, j in enumerate(p)))
    assert len(exhaustive) == len(list(permutations(range(int(nhd)), int(nqd))))
    for beam in (1, 5, 25):
        got = tmd._beam_paths(hd, mtx, beam=beam)
        assert got == jmd._beam_paths(hd, mtx, beam=beam)
        gs = [sum(mtx[i, j] for i, j in enumerate(p)) for p in got]
        ws = [sum(mtx[i, j] for i, j in enumerate(p)) for p in exhaustive[:beam]]
        np.testing.assert_allclose(gs, ws, rtol=1e-12)
    full = tmd._beam_paths(hd, mtx, beam=len(exhaustive) + 10)
    assert [tuple(p) for p in full] == [tuple(p) for p in exhaustive]


def test_expand_chain_neighbourhood(tmp_path):
    rng = np.random.default_rng(2)
    names = ["aaa_01", "aaa_02", "bbb_01", "ccc_01", "ccc_02", "ccc_03", "ddd"]
    c = rng.normal(size=(30, 3)).astype(np.float32)
    prefix = str(tmp_path / "db")
    codecs.write_pt_db(prefix, rng.normal(size=(7, 128)).astype(np.float32),
                       [(n, c, "A" * 30) for n in names])
    db = codecs.FlatDB.open(prefix)
    from merizo_search_tpu.db import codecs as jcodecs

    jdb = jcodecs.FlatDB.open(prefix)
    for i, n in enumerate(names):
        got = tmd._expand_chain_neighbourhood(db, i, tmd.domid2chainid(n))
        assert got == jmd._expand_chain_neighbourhood(jdb, i, jmd.domid2chainid(n))
    assert tmd._expand_chain_neighbourhood(db, 4, "ccc") == [3, 4, 5]
    assert tmd._expand_chain_neighbourhood(db, 2, "bbb") == []


@pytest.fixture(scope="module")
def chain_db(tmp_path_factory):
    """Chain-ordered DB: chainX (3 domains), chainY (2, copies of chainX's
    first two), chainW (2, chainX's domains 2 and 1 in that order) and a
    single-domain zsolo; embeddings from the default Foldclass weights."""
    from merizo_search_tpu_torch.pipeline.embed import embed_structures, load_foldclass_params

    rng = np.random.default_rng(0)
    folds = [np.cumsum(rng.normal(size=(n, 3)) * 1.8, axis=0).astype(np.float32)
             for n in (70, 85, 64, 77)]
    names = ["chainX_01", "chainX_02", "chainX_03", "chainY_01", "chainY_02",
             "chainW_01", "chainW_02", "zsolo_01"]
    coords = [folds[0], folds[1], folds[2], folds[0], folds[1], folds[1], folds[0], folds[3]]
    embs = embed_structures(load_foldclass_params(None, "cpu"), coords)
    prefix = str(tmp_path_factory.mktemp("chains") / "chains")
    codecs.write_pt_db(prefix, embs, [(n, c, "A" * len(c)) for n, c in zip(names, coords)])
    queries = [{"name": "myq_merizo_01", "coords": folds[0], "seq": "A" * 70},
               {"name": "myq_merizo_02", "coords": folds[1], "seq": "A" * 85}]
    hits = [{0: {"query": "myq_merizo_01", "target": "chainX_01", "dbindex": 0},
             1: {"query": "myq_merizo_01", "target": "chainY_01", "dbindex": 3}},
            {0: {"query": "myq_merizo_02", "target": "chainX_02", "dbindex": 1},
             1: {"query": "myq_merizo_02", "target": "chainW_01", "dbindex": 5}}]
    return prefix, queries, hits


def _split(row):
    """(row without scores, [scores]) of a result tuple."""
    info = [f.split(":") for f in row[5].split(",")]
    return (row[:5] + (tuple((a, b) for a, b, _ in info),) + row[6:],
            [float(s) for _, _, s in info])


@pytest.mark.parametrize("mode,mintm", [("exhaustive_tmalign", 0.5), ("embscore", 0.999)])
def test_multi_domain_search_matches_jax(chain_db, mode, mintm):
    prefix, queries, hits = chain_db
    kw = dict(inputs_from_easy_search=True, mintm=mintm, mode=mode)
    want = jmd.multi_domain_search(queries, hits, prefix, **kw)
    got = tmd.multi_domain_search(queries, hits, prefix, device="cpu", **kw)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        gr, gs = _split(g)
        wr, ws = _split(w)
        assert gr == wr
        if mode == "exhaustive_tmalign":
            assert g[5] == w[5]                   # the printed TM-scores too
        else:
            np.testing.assert_allclose(gs, ws, atol=COS_TOL)
    cats = {}
    for qc, nqd, hc, nhd, cat, _, _ in got:
        assert qc == "myq" and nqd == 2
        cats.setdefault(hc, set()).add(cat)
    assert 2 in cats["chainX"] and 3 in cats["chainY"] and 0 in cats["chainW"]
    assert "zsolo" not in cats


def test_multi_domain_search_one_query_and_device_aligner(chain_db):
    """One query domain gives no result; the device aligner (backend "tpu",
    here on the CPU) gives the JAX package's device-aligner rows, with
    TM-scores within 1e-3 (tests/test_torch_tmalign.py's tolerance)."""
    prefix, queries, hits = chain_db
    assert tmd.multi_domain_search(queries[:1], hits[:1], prefix, device="cpu") is None
    kw = dict(inputs_from_easy_search=True, tmalign_backend="tpu")
    want = jmd.multi_domain_search(queries, hits, prefix, **kw)
    got = tmd.multi_domain_search(queries, hits, prefix, device="cpu", **kw)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        gr, gs = _split(g)
        wr, ws = _split(w)
        assert gr == wr
        np.testing.assert_allclose(gs, ws, atol=1e-3)
