"""The port's `createdb` and `dbinfo` against the JAX package's.

Both packages build from one directory of synthetic PDBs (made with numpy
from a seed) and embed with the same default Foldclass weights (the JAX
`PRNGKey(0)` init, which the port ships). Names, coordinates, sequences and
lengths must be byte-identical; embeddings agree within 1e-4, the Foldclass
tolerance of tests/test_torch_foldclass.py (float32 on the CPU, different
summation orders). Quantised sidecars are byte-identical when both writers
quantise the same float32 rows; across two builds, whose rows differ by
the embedding tolerance, scales agree within 1e-6 relative and int8 codes
within 1.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from merizo_search_tpu import cli as jcli
from merizo_search_tpu.db import codecs as jcodecs
from merizo_search_tpu.pipeline import createdb as jcreatedb
from merizo_search_tpu.pipeline.embed import load_foldclass_params as jax_load_params
from merizo_search_tpu_torch import cli as tcli
from merizo_search_tpu_torch.db import codecs as tcodecs
from merizo_search_tpu_torch.io import native_parse, pdb as tpdb
from merizo_search_tpu_torch.pipeline import createdb as tcreatedb
from merizo_search_tpu_torch.pipeline.embed import load_foldclass_params

EMB_TOL = 1e-4
SCORE_TOL = 2e-4       # fp32 emb_score, as tests/test_torch_default_weights.py
TRUNC = 150            # the MAX_RES cap both builders are run with here


def _walk(rng, n):
    steps = rng.normal(size=(n, 3))
    for i in range(1, n):
        steps[i] = 0.6 * steps[i - 1] + 0.4 * steps[i]
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    return np.cumsum(steps * 3.8, axis=0).astype(np.float32)


AA3 = ("ALA", "GLY", "LEU", "SER", "MSE", "UNK", "TRP", "LYS")


def _write_pdb(path, coords, rng, chain="A"):
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords, start=1):
            fh.write(f"ATOM  {i:5d}  CA  {AA3[rng.integers(len(AA3))]} {chain}{i:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00\n")
        fh.write("END\n")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads a test process: the suite runs six processes at
    once, and torch's default of one thread a core then oversubscribes the
    machine many times over (spinning OpenMP workers slow every process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory):
    """Twelve chains of 50-300 residues, two longer than TRUNC, one file no
    parser can read and one with no chain A (both skipped with a warning)."""
    d = tmp_path_factory.mktemp("pdbs")
    rng = np.random.default_rng(11)
    lengths = [int(n) for n in rng.integers(50, 301, 10)] + [TRUNC + 40, TRUNC + 90]
    chains = []
    for i, n in enumerate(lengths):
        chains.append(_walk(rng, n))
        _write_pdb(str(d / f"c{i:02d}.pdb"), chains[-1], rng)
    (d / "broken.pdb").write_text("ATOM  garbage\n")
    _write_pdb(str(d / "chain_b.pdb"), _walk(rng, 60), rng, chain="B")
    (d / "notes.txt").write_text("not a structure\n")
    return str(d), chains


@pytest.fixture(scope="module")
def builds(pdb_dir, tmp_path_factory):
    """Each package's pt build and mmap builds with int8 and bf16 sidecars,
    with MAX_RES lowered to TRUNC in both builders (the embedders'
    own 2000 cap is then never reached), so truncation runs at test size."""
    d, _ = pdb_dir
    out = tmp_path_factory.mktemp("builds")
    jparams = jax_load_params(None)
    model = load_foldclass_params(None, "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jcreatedb, "MAX_RES", TRUNC)
    mp.setattr(tcreatedb, "MAX_RES", TRUNC)
    try:
        res = {}
        for pkg, run, kw in (("jax", jcreatedb.run_createdb, {"params": jparams}),
                             ("port", tcreatedb.run_createdb, {"model": model})):
            for layout, sidecar in (("pt", None), ("mmap", "int8"), ("mmap", "bf16")):
                prefix = str(out / pkg / f"{layout}_{sidecar}" / "db")
                os.makedirs(os.path.dirname(prefix))
                n = run(d, prefix, fmt=layout, sidecar=sidecar, **kw)
                res[pkg, layout, sidecar] = (prefix, n)
    finally:
        mp.undo()
    return res


def _files(prefix):
    d = os.path.dirname(prefix)
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("layout,sidecar", [("pt", None), ("mmap", "int8"), ("mmap", "bf16")])
def test_port_build_equals_the_jax_build(builds, layout, sidecar):
    (jp, jn), (tp, tn) = builds["jax", layout, sidecar], builds["port", layout, sidecar]
    assert jn == tn == 12                       # broken.pdb and chain_b.pdb skipped
    jdb, tdb = jcodecs.FlatDB.open(jp), tcodecs.FlatDB.open(tp)
    assert tdb.kind == jdb.kind and tdb.size == jdb.size
    np.testing.assert_array_equal(tdb.lengths(), jdb.lengths())
    assert int(tdb.lengths().max()) == TRUNC
    for i in range(jdb.size):
        (jname, jc, jseq), (tname, tc, tseq) = jdb.entry(i), tdb.entry(i)
        assert tname == jname and tseq == jseq
        assert tc.tobytes() == jc.tobytes()
    np.testing.assert_allclose(np.asarray(tdb.embeddings()), np.asarray(jdb.embeddings()),
                               atol=EMB_TOL)
    if layout == "pt":
        return
    jf, tf = _files(jp), _files(tp)
    assert sorted(tf) == sorted(jf)
    emb_files = {"db_raw_128d_norm.db", f"db_raw_128d_norm.{sidecar}",
                 "db_raw_128d_norm.scales"}
    for f in jf:
        if f not in emb_files:
            assert tf[f] == jf[f], f            # names, seqs, coords, indexes, json, progress
    if sidecar == "int8":
        jq, tq = (np.asarray(db.read_rows_quant(0, db.size, "int8")[0], np.int16)
                  for db in (jdb, tdb))
        assert np.abs(tq - jq).max() <= 1
        np.testing.assert_allclose(np.asarray(tdb._scales), np.asarray(jdb._scales),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_sidecar_writer_is_byte_identical(builds, tmp_path, kind):
    """Both sidecar writers on copies of one float32 DB write the same bytes."""
    src = os.path.dirname(builds["jax", "mmap", "int8"][0])
    for pkg in ("jax", "port"):
        shutil.copytree(src, tmp_path / pkg)
    jcodecs.write_quantized_sidecar(str(tmp_path / "jax" / "db"), kind)
    tcodecs.write_quantized_sidecar(str(tmp_path / "port" / "db"), kind)
    assert _files(str(tmp_path / "port" / "db")) == _files(str(tmp_path / "jax" / "db"))


@pytest.mark.parametrize("layout", ["pt", "mmap"])
def test_each_package_opens_the_others_db(builds, layout):
    sidecar = None if layout == "pt" else "int8"
    for opener, builder in ((jcodecs.FlatDB, "port"), (tcodecs.FlatDB, "jax")):
        prefix, n = builds[builder, layout, sidecar]
        db = opener.open(prefix)
        own = (tcodecs if builder == "port" else jcodecs).FlatDB.open(prefix)
        assert db.size == n and db.kind == own.kind
        assert db.has_quant("int8") == (sidecar == "int8")
        for i in range(n):
            a, b = db.entry(i), own.entry(i)
            assert a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1], b[1])
        np.testing.assert_array_equal(np.asarray(db.embeddings()), np.asarray(own.embeddings()))


def test_resume_after_an_interrupted_build_equals_one_build(pdb_dir, tmp_path, monkeypatch):
    """An mmap build killed after its first chunk, then resumed, writes the
    same bytes as one uninterrupted build of the same chunking."""
    d, _ = pdb_dir
    model = load_foldclass_params(None, "cpu")
    whole = str(tmp_path / "whole" / "db")
    tcreatedb.run_createdb(d, whole, fmt="mmap", chunk_files=4, model=model, sidecar="int8")

    real, calls = tcreatedb.embed_structures, []

    def crash_after_first_chunk(*a, **kw):
        if calls:
            raise KeyboardInterrupt("killed")
        calls.append(1)
        return real(*a, **kw)

    part = str(tmp_path / "part" / "db")
    monkeypatch.setattr(tcreatedb, "embed_structures", crash_after_first_chunk)
    with pytest.raises(KeyboardInterrupt):
        tcreatedb.run_createdb(d, part, fmt="mmap", chunk_files=4, model=model)
    monkeypatch.setattr(tcreatedb, "embed_structures", real)
    assert not os.path.exists(part + ".json")
    # a torn write after the checkpoint: resume must drop it
    with open(os.path.join(os.path.dirname(part), "db_seq.db"), "ab") as fh:
        fh.write(b"TORN")
    n = tcreatedb.run_createdb(d, part, fmt="mmap", chunk_files=4, model=model,
                               resume=True, sidecar="int8")
    assert n == 12
    assert _files(part) == _files(whole)


def test_truncate_mmap_db_matches_jax(builds, tmp_path):
    src = os.path.dirname(builds["port", "mmap", "int8"][0])
    for pkg, mod in (("jax", jcodecs), ("port", tcodecs)):
        shutil.copytree(src, tmp_path / pkg)
        mod.truncate_mmap_db(str(tmp_path / pkg / "db"), 5)
    got, want = _files(str(tmp_path / "port" / "db")), _files(str(tmp_path / "jax" / "db"))
    assert got == want
    assert len(got["db_raw_128d.index_names"]) == 5 * tcodecs.NAME_RECORD


def test_from_arrays_matches_jax(pdb_dir):
    _, chains = pdb_dir
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(len(chains), 128)).astype(np.float32)
    entries = [(f"e{i}", c, "A" * len(c)) for i, c in enumerate(chains)]
    jdb = jcodecs.FlatDB.from_arrays(emb, entries, normalised=True)
    tdb = tcodecs.FlatDB.from_arrays(emb, entries, normalised=True)
    assert (tdb.kind, tdb.size, tdb.dim, tdb.normalised) == (jdb.kind, jdb.size, jdb.dim, True)
    np.testing.assert_array_equal(tdb.lengths(), jdb.lengths())
    np.testing.assert_array_equal(tdb.embeddings(), jdb.embeddings())
    for i in range(len(entries)):
        a, b = tdb.entry(i), jdb.entry(i)
        assert a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1], b[1])


def test_native_ca_parser_equals_the_numpy_path(pdb_dir, tmp_path):
    """The C++ scan against the numpy specification, on the build's files
    and on records the CA rules single out: HETATM, other chains, other atom
    names, a truncated line, an unknown residue."""
    d, _ = pdb_dir
    assert native_parse.available()
    odd = tmp_path / "odd.pdb"
    odd.write_text(
        "HETATM    1  CA  MSE A   1      10.000  11.000  12.000  1.00  0.00\n"
        "ATOM      2  CA  GLY A   2       1.500  -2.250   3.125  1.00  0.00\n"
        "ATOM      3  CB  GLY A   2       9.000   9.000   9.000  1.00  0.00\n"
        "ATOM      4  CA  XYZ B   3       4.000   5.000   6.000  1.00  0.00\n"
        "ATOM      5  CA  FOO A   4      -7.000   8.000\n"
        "ATOM      6  CA  TRP A   5     100.125-200.500 300.750\n")
    paths = [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.startswith("c")]
    for path in paths + [str(odd)]:
        for chain in ("A", "B"):
            try:
                want = tpdb.read_ca_numpy(path, chain)
            except ValueError:
                with pytest.raises(ValueError):
                    tpdb.read_ca(path, chain)
                continue
            got = tpdb.read_ca(path, chain)
            assert got["seq"] == want["seq"]
            assert got["coords"].tobytes() == want["coords"].tobytes()
    assert tpdb.read_ca(str(odd))["seq"] == "GXW"


def _tsv_rows(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def test_cli_createdb_without_weights_searches_like_the_jax_db(pdb_dir, tmp_path):
    """The port's CLI createdb (no --weights) and the JAX CLI's, each then
    searched by the JAX CLI: the same hits, ranks and TM-align fields,
    emb_score within SCORE_TOL."""
    d, chains = pdb_dir
    rng = np.random.default_rng(5)
    queries = []
    for i in (1, 4, 7):          # perturbed copies of three DB chains
        queries.append(str(tmp_path / f"q{i}.pdb"))
        _write_pdb(queries[-1], chains[i] + rng.normal(scale=0.5, size=chains[i].shape), rng)
    tcli.main(["createdb", d, str(tmp_path / "port_db" / "db"), "-d", "cpu"])
    jcli.main(["createdb", d, str(tmp_path / "jax_db" / "db"), "-d", "cpu"])
    flags = ["-k", "5", "--precision", "fp32", "--output_headers", "-d", "cpu"]
    for db in ("port_db", "jax_db"):
        jcli.main(["search", *queries, str(tmp_path / db / "db"), str(tmp_path / db / "res"),
                   *flags])
    jrows = _tsv_rows(str(tmp_path / "jax_db" / "res_search.tsv"))
    trows = _tsv_rows(str(tmp_path / "port_db" / "res_search.tsv"))
    assert len(trows) == len(jrows) >= 4
    col = jrows[0].index("emb_score")
    assert trows[0] == jrows[0]
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:col] + t[col + 1:] == j[:col] + j[col + 1:]
        assert abs(float(t[col]) - float(j[col])) <= SCORE_TOL
    top = {r[0]: os.path.basename(r[jrows[0].index("target")]) for r in trows[1:]
           if r[1] == "0"}
    assert top == {"q1": "c01", "q4": "c04", "q7": "c07"}


def test_dbinfo_prints_what_the_jax_verb_prints(builds, tmp_path, capsys):
    src = os.path.dirname(builds["port", "mmap", "int8"][0])
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        shutil.copytree(src, tmp_path / pkg)
        capsys.readouterr()
        main(["dbinfo", str(tmp_path / pkg / "db"), "--verify", "--sample", "0",
              "--ids", "0,5,11", "--write-sidecar", "bf16"])
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "sidecars:   int8 bf16" in out["port"] and "verify:     12/12 entries OK" in out["port"]
    assert _files(str(tmp_path / "port" / "db")) == _files(str(tmp_path / "jax" / "db"))


@pytest.mark.parametrize("argv", [["createdb", "in", "out"], ["segment", "x.pdb", "out"]])
def test_cli_verbs_raise_on_cuda_without_a_card(argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "in").mkdir()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        tcli.main([*argv, "-d", "cuda"])
