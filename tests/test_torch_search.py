"""The port's `search` path against the JAX package's, end to end.

One synthetic DB (a few thousand rows, pt and mmap layouts written by the
port's codecs and read by both packages), one state dict (the reference-
named weights of tests/golden/foldclass.npz) and the same query PDBs go
through the JAX `run_dbsearch` and the port's (on the CPU); each package
writes its TSVs with its own writer and the files are compared field by
field.

Each query has planted DB rows at cosines 0.98 down to 0.55 (0.05 apart,
so no storage precision reorders them) with coordinates near its own or
those of a longer chain; every other row is a random unit vector (|cos| <
0.45, below mincos). Tolerances on emb_score: 2e-4 at fp32 (the two
packages' embeddings differ by ~1e-6 and the TSV rounds to 4 decimals),
5e-3 at bf16 and int8 (the JAX CPU scan keeps f32 queries; the port scores
bf16 or int8 queries, as on the card). Every other field is compared
exactly: the hit sets, ranks, lengths and TM-align output must be equal.
"""

import os

import numpy as np
import pytest
import torch

from merizo_search_tpu.models import foldclass as jfc
from merizo_search_tpu.pipeline.dbsearch import run_dbsearch as jax_run_dbsearch
from merizo_search_tpu.io import results as jresults
from merizo_search_tpu_torch.db import codecs
from merizo_search_tpu_torch.io import results as tresults
from merizo_search_tpu_torch.models import foldclass as tfc
from merizo_search_tpu_torch.pipeline.dbsearch import run_dbsearch
from merizo_search_tpu_torch.pipeline.embed import embed_structures

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "foldclass.npz")
N_DB = 3000
COSINES = (0.98, 0.93, 0.88, 0.83, 0.78, 0.73, 0.68, 0.63, 0.55)
SCORE_TOL = {"fp32": 2e-4, "bf16": 5e-3, "int8": 5e-3}


def _walk(rng, n):
    """Protein-like CA trace: 3.8 A steps with a persistent direction."""
    steps = rng.normal(size=(n, 3))
    for i in range(1, n):
        steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(steps * 3.8, axis=0).astype(np.float32)


def _write_pdb(path, coords):
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords, start=1):
            fh.write(f"ATOM  {i:5d}  CA  ALA A{i:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
        fh.write("END\n")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_search")
    z = np.load(GOLDEN)
    sd = {k[len("sd."):]: z[k] for k in z.files if k.startswith("sd.")}
    model = tfc.FoldClassNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.eval()
    rng = np.random.default_rng(21)

    qcoords = [_walk(rng, n) for n in (64, 97, 150, 210)]
    pdbs = []
    for i, c in enumerate(qcoords):
        pdbs.append(str(tmp / f"query{i}.pdb"))
        _write_pdb(pdbs[-1], c)
        qcoords[i] = np.round(c.astype(np.float64), 3).astype(np.float32)
    qemb = embed_structures(model, qcoords)
    qemb /= np.linalg.norm(qemb, axis=1, keepdims=True)

    emb = rng.normal(size=(N_DB, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    pool = [_walk(rng, n) for n in (80, 120, 260)]
    entries = [(f"d{i:05d}", pool[i % 3], "A" * len(pool[i % 3])) for i in range(N_DB)]
    for qi, (e, c) in enumerate(zip(qemb, qcoords)):
        for j, cos in enumerate(COSINES):
            row = 97 + 331 * qi + 29 * j
            u = rng.normal(size=128)
            u -= (u @ e) * e
            u /= np.linalg.norm(u)
            emb[row] = cos * e + np.sqrt(1 - cos * cos) * u
            if j % 4 == 3:     # a longer chain: the mincov filters drop it
                tc = np.concatenate([c, c + 40.0])
            else:              # the query's own fold, more perturbed further down
                tc = c + rng.normal(scale=0.3 * (j + 1), size=c.shape).astype(np.float32)
            entries[row] = (f"hit_q{qi}_{j}", tc, "A" * len(tc))
    prefix = str(tmp / "db")
    codecs.write_pt_db(prefix + "_pt", emb, entries)
    w = codecs.MmapDBWriter(prefix + "_mmap")
    for (name, ca, seq), e in zip(entries, emb):
        w.add(name, e, ca, seq)
    w.finalize()
    return dict(tmp=tmp, pdbs=pdbs, model=model,
                jparams=jfc.params_from_torch_state_dict(sd), prefix=prefix)


def _tsv_rows(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


@pytest.mark.parametrize("layout,precision", [
    ("pt", "fp32"), ("pt", "bf16"), ("mmap", "fp32"), ("mmap", "bf16"),
    ("mmap_cov", "fp32"), ("mmap_cov", "bf16"), ("mmap_cov", "int8")])
def test_run_dbsearch_tsv_matches_jax(setup, layout, precision):
    db = setup["prefix"] + ("_pt" if layout == "pt" else "_mmap")
    kw = dict(topk=9, mmap_cov_filter=layout == "mmap_cov", precision=precision)
    jres = jax_run_dbsearch(setup["pdbs"], db, params=setup["jparams"], **kw)
    tres = run_dbsearch(setup["pdbs"], db, model=setup["model"], device="cpu", **kw)
    fields = jresults.SEARCH_FIELDS.split(",")
    out = setup["tmp"] / f"{layout}_{precision}"
    n_sig = 0
    for kind, jr, tr in (("sig", jres[0], tres[0]), ("insig", jres[1], tres[1])):
        jresults.write_search_results(jr, f"{out}_jax_{kind}.tsv", fields, header=True)
        tresults.write_search_results(tr, f"{out}_torch_{kind}.tsv", fields, header=True)
        jrows = _tsv_rows(f"{out}_jax_{kind}.tsv")
        trows = _tsv_rows(f"{out}_torch_{kind}.tsv")
        assert len(trows) == len(jrows)
        assert trows[0] == jrows[0] == fields
        col = fields.index("emb_score")
        for t, j in zip(trows[1:], jrows[1:]):
            assert t[:col] + t[col + 1:] == j[:col] + j[col + 1:]
            assert abs(float(t[col]) - float(j[col])) <= SCORE_TOL[precision]
        if kind == "sig":
            n_sig = len(trows) - 1
    # the planted hits are found: at least 2 significant per query
    assert n_sig >= 2 * len(setup["pdbs"])
    if layout != "mmap":   # the mincov filters drop every longer chain
        assert not any(h["target"].endswith(("_3", "_7"))
                       for r in tres[0] + tres[1] for h in r.values())


def test_cli_search_writes_the_same_tsv(setup):
    """`python -m merizo_search_tpu_torch.cli search ... -d cpu` writes the
    TSV that run_dbsearch plus the writer give."""
    from merizo_search_tpu_torch import cli

    db = setup["prefix"] + "_pt"
    out = str(setup["tmp"] / "cli" / "res")
    weights = str(setup["tmp"] / "foldclass.pt")
    torch.save(setup["model"].state_dict(), weights)
    cli.main(["search", *setup["pdbs"], db, out, "-k", "9", "-d", "cpu",
              "--precision", "fp32", "--output_headers", "--weights", weights])
    res, _ = run_dbsearch(setup["pdbs"], db, topk=9, model=setup["model"],
                          device="cpu", precision="fp32")
    fields = tresults.SEARCH_FIELDS.split(",")
    tresults.write_search_results(res, out + "_want.tsv", fields, header=True)
    assert _tsv_rows(out + "_search.tsv") == _tsv_rows(out + "_want.tsv")


@pytest.mark.parametrize("flag", [["search", "--mesh", "2"], ["easy-search", "--mesh", "2"]])
def test_cli_unported_modes_raise(setup, flag):
    """The mesh mode on both search verbs: `--mesh 2 -d cpu` (the DB on two
    CPU shards) writes the TSV the verb writes without --mesh. easy-search
    segments a helical backbone first (the port's seeded Merizo init);
    mincos 0 keeps every hit, so each domain's k rows are compared."""
    from merizo_search_tpu_torch import cli
    from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

    verb = flag[0]
    tmp = setup["tmp"] / f"mesh_{verb}"
    tmp.mkdir()
    if verb == "search":
        inputs, seg = setup["pdbs"], []
    else:
        rng = np.random.default_rng(8)
        inputs, seg = [str(tmp / "chain.pdb")], ["--merizo_output", str(tmp)]
        write_backbone_pdb(inputs[0], helical_backbone(rng, 180), rng)
    weights = str(tmp / "foldclass.pt")
    torch.save(setup["model"].state_dict(), weights)
    for tag, extra in (("one", []), ("mesh", flag[1:])):
        cli.main([verb, *inputs, setup["prefix"] + "_pt", str(tmp / tag), "-d", "cpu",
                  "-k", "5", "--mincos", "0", "--skip_tmalign", "--weights", weights,
                  *seg, *extra])
    rows = _tsv_rows(str(tmp / "mesh_search.tsv"))
    assert len(rows) >= 5
    assert rows == _tsv_rows(str(tmp / "one_search.tsv"))


@pytest.mark.parametrize("kind,precision", [("int8", "int8"), ("bf16", "bf16")])
def test_quantized_sidecar_matches_jax_and_is_read(setup, tmp_path, kind, precision):
    """The port writes the same sidecar bytes as the JAX package, and its
    engine returns the same top-k reading the sidecar as quantising the f32
    rows itself."""
    import glob
    import shutil
    from merizo_search_tpu.db import codecs as jcodecs
    from merizo_search_tpu_torch.search.engine import SearchEngine

    src = setup["prefix"] + "_mmap"
    for tag in ("torch", "jax"):
        os.makedirs(tmp_path / tag)
        for f in glob.glob(src + "*"):
            shutil.copy(f, tmp_path / tag)
    mine, ref = str(tmp_path / "torch" / "db_mmap"), str(tmp_path / "jax" / "db_mmap")
    codecs.write_quantized_sidecar(mine, kind, chunk_rows=1000)
    jcodecs.write_quantized_sidecar(ref, kind)
    for suffix in ([".int8", ".scales"] if kind == "int8" else [".bf16"]):
        with open(mine + "_raw_128d_norm" + suffix, "rb") as a, \
                open(ref + "_raw_128d_norm" + suffix, "rb") as b:
            assert a.read() == b.read()
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, 128)).astype(np.float32)
    qlen = rng.integers(60, 300, 6)
    with_side = codecs.FlatDB.open(mine)
    assert with_side.has_quant(kind)
    got = SearchEngine(with_side, dtype=precision, device="cpu").search(
        q, 20, query_lens=qlen, mincov=0.7)
    want = SearchEngine(codecs.FlatDB.open(src), dtype=precision, device="cpu").search(
        q, 20, query_lens=qlen, mincov=0.7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
