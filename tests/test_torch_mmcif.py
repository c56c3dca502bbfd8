"""The port's mmCIF readers (io/mmcif.py) against the JAX package's, and the
helpers that had no twin in the port (FlatDB.iter_blocks, write_ca_pdb).

Synthetic mmCIF text is made with numpy from a seed, as
tests/test_mmcif.py::_as_mmcif writes it: CA-only chains for `read_ca`,
N/CA/C/O backbones for `parse_backbone` (with a HETATM MSE, an excluded
UNK residue, an alternate location, a second chain and a second model),
columns in file order and reversed, plain `.cif`, `.mmcif` and `.cif.gz`.
Every comparison is exact: both packages parse the same text with the same
rules. Then the port's `segment_structures` on the CPU gives the same
domains for one chain written as `.cif` and as `.pdb`.
"""

import gzip

import numpy as np
import pytest
import torch

from merizo_search_tpu.db import codecs as jax_codecs
from merizo_search_tpu.io import mmcif as jax_mmcif
from merizo_search_tpu.io import pdb as jax_pdb
from merizo_search_tpu_torch.db import codecs as t_codecs
from merizo_search_tpu_torch.io import mmcif as t_mmcif
from merizo_search_tpu_torch.io import pdb as t_pdb
from merizo_search_tpu_torch.tools.synthetic import AA3, ATOMS, helical_backbone

FIELDS = ["group_PDB", "id", "label_atom_id", "label_alt_id", "label_comp_id",
          "auth_asym_id", "auth_seq_id", "Cartn_x", "Cartn_y", "Cartn_z", "occupancy",
          "B_iso_or_equiv", "pdbx_PDB_model_num"]


def _as_mmcif(records, shuffle_cols=False) -> str:
    """records: dicts of FIELDS values -> one `_atom_site` loop."""
    fields = FIELDS[::-1] if shuffle_cols else FIELDS
    lines = ["data_test", "#", "loop_"] + [f"_atom_site.{f}" for f in fields]
    lines += [" ".join(r[f] for f in fields) for r in records]
    return "\n".join(lines + ["#"]) + "\n"


def _record(k, name, resn, chain, resi, xyz, alt=".", occ=1.0, grp="ATOM", model=1):
    return {"group_PDB": grp, "id": str(k), "label_atom_id": name, "label_alt_id": alt,
            "label_comp_id": resn, "auth_asym_id": chain, "auth_seq_id": str(resi),
            "Cartn_x": f"{xyz[0]:.3f}", "Cartn_y": f"{xyz[1]:.3f}",
            "Cartn_z": f"{xyz[2]:.3f}", "occupancy": f"{occ:.2f}", "B_iso_or_equiv": "50.00",
            "pdbx_PDB_model_num": str(model)}


def _backbone_records(rng, n, chain="A", atoms=ATOMS, quirks=True):
    """An [n, 4, 3] helical backbone as records of `atoms`; with quirks, a
    HETATM MSE, an UNK residue, an alternate location of lower occupancy,
    a second chain and a second model that the readers must drop."""
    bb = helical_backbone(rng, n)
    names = [AA3[j] for j in rng.integers(0, 20, n)]
    if quirks:
        names[3], names[7] = "MSE", "UNK"
    recs, k = [], 0
    for r, (res, resn) in enumerate(zip(bb, names), start=1):
        for name, xyz in zip(ATOMS, res):
            if name not in atoms:
                continue
            k += 1
            grp = "HETATM" if resn == "MSE" else "ATOM"
            if quirks and r == 5 and name == "CA":
                recs.append(_record(k, name, resn, chain, r, xyz, "A", 0.6, grp))
                k += 1
                recs.append(_record(k, name, resn, chain, r, xyz + 0.5, "B", 0.4, grp))
            else:
                recs.append(_record(k, name, resn, chain, r, xyz, grp=grp))
    if quirks:
        other = bb[:4] + 30.0
        for r, res in enumerate(other, start=1):
            for name, xyz in zip(ATOMS, res):
                k += 1
                recs.append(_record(k, name, "GLY", "B", r, xyz))
        for name, xyz in zip(ATOMS, bb[0] + 1.0):
            k += 1
            recs.append(_record(k, name, names[0], chain, 1, xyz, model=2))
    return recs


def _write(path, text):
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        with open(path, "w") as fh:
            fh.write(text)
    return path


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(18)


@pytest.mark.parametrize("suffix", [".cif", ".mmcif", ".cif.gz"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("chain", ["A", "B"])
def test_read_ca_mmcif_matches_jax(tmp_path, rng, suffix, shuffle, chain):
    text = _as_mmcif(_backbone_records(rng, 60, atoms=("CA",)), shuffle)
    path = _write(str(tmp_path / f"s{suffix}"), text)
    want = jax_mmcif.read_ca_mmcif(path, chain)
    got = t_mmcif.read_ca_mmcif(path, chain)
    assert got["seq"] == want["seq"] and got["name"] == want["name"]
    np.testing.assert_array_equal(got["coords"], want["coords"])
    assert got["coords"].dtype == want["coords"].dtype
    via = t_pdb.read_ca(path, chain)             # io.pdb dispatches on the suffix
    assert via["seq"] == want["seq"]
    np.testing.assert_array_equal(via["coords"], jax_pdb.read_ca(path, chain)["coords"])


@pytest.mark.parametrize("suffix", [".cif", ".mmcif", ".cif.gz"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("chain", ["A", "B"])
def test_parse_backbone_mmcif_matches_jax(tmp_path, rng, suffix, shuffle, chain):
    text = _as_mmcif(_backbone_records(rng, 40), shuffle)
    path = _write(str(tmp_path / f"s{suffix}"), text)
    want = jax_mmcif.parse_backbone_mmcif(path, chain)
    got = t_mmcif.parse_backbone_mmcif(path, chain)
    assert got.dtype == want.dtype and len(got) > 0
    np.testing.assert_array_equal(got, want)
    via = t_pdb.parse_backbone(path, chain)
    np.testing.assert_array_equal(via, jax_pdb.parse_backbone(path, chain))
    np.testing.assert_array_equal(via, want)


def test_three_residue_mmcif_backbone(tmp_path, rng):
    """The smallest case: three complete residues, twelve atoms."""
    path = _write(str(tmp_path / "tiny.cif"),
                  _as_mmcif(_backbone_records(rng, 3, quirks=False)))
    got = t_pdb.parse_backbone(path, "A")
    assert got.shape == (12,)
    np.testing.assert_array_equal(got, jax_pdb.parse_backbone(path, "A"))


def test_missing_chain(tmp_path, rng):
    path = _write(str(tmp_path / "s.cif"),
                  _as_mmcif(_backbone_records(rng, 10, quirks=False)))
    with pytest.raises(ValueError):
        t_pdb.read_ca(path, "C")
    assert len(t_pdb.parse_backbone(path, "C")) == len(jax_pdb.parse_backbone(path, "C")) == 0


def test_to_int_matches_jax():
    for v in ("12", "-3", "?", ".", None, "4.5"):
        assert t_mmcif._to_int(v) == jax_mmcif._to_int(v)
        assert t_mmcif._to_int(v, 7) == jax_mmcif._to_int(v, 7)


def _write_backbone_mmcif(path, bb, names, chain="A"):
    recs, k = [], 0
    for r, (res, resn) in enumerate(zip(bb, names), start=1):
        for name, xyz in zip(ATOMS, res):
            k += 1
            recs.append(_record(k, name, resn, chain, r, xyz))
    return _write(path, _as_mmcif(recs))


def test_segment_same_domains_from_cif_and_pdb(tmp_path):
    """One two-domain chain written as PDB and as mmCIF: the port's
    segment_structures on the CPU chops both the same way (domain ids and
    count equal, confidences equal bit for bit: the parsed arrays are
    equal, and each file goes through a forward of its own)."""
    from merizo_search_tpu_torch.models.merizo import network as tnet
    from merizo_search_tpu_torch.segment.pipeline import segment_structures

    rng = np.random.default_rng(5)
    bb = helical_backbone(rng, 150)
    names = [AA3[j] for j in rng.integers(0, 20, len(bb))]
    pdb = str(tmp_path / "c.pdb")
    with open(pdb, "w") as fh:
        k = 0
        for r, (res, resn) in enumerate(zip(bb, names), start=1):
            for name, (x, y, z) in zip(ATOMS, res):
                k += 1
                fh.write(f"ATOM  {k:5d}  {name:<3s} {resn} A{r:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00 50.00           {name[0]}\n")
        fh.write("END\n")
    cif = _write_backbone_mmcif(str(tmp_path / "c.cif"), bb, names)
    a, b = t_pdb.parse_backbone(pdb, "A"), t_pdb.parse_backbone(cif, "A")
    for f in ("n", "resn", "resi", "x", "y", "z"):
        np.testing.assert_array_equal(a[f], b[f])
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = tnet.model_from_state_dict(tnet.init_state_dict(3), "cpu")
        # one call each: two chains in one batch would differ in the last bits
        (got_pdb,), (got_cif,) = (segment_structures(model, [p], ["A"]) for p in (pdb, cif))
    finally:
        torch.set_num_threads(n_threads)
    assert got_pdb["nres"] == got_cif["nres"] == 150
    np.testing.assert_array_equal(got_pdb["domain_ids"], got_cif["domain_ids"])
    assert got_pdb["ndom"] == got_cif["ndom"]
    np.testing.assert_array_equal(got_pdb["conf_res"], got_cif["conf_res"])


@pytest.mark.parametrize("batch", [8, 25, 100])
def test_iter_blocks_matches_jax(tmp_path, batch):
    rng = np.random.default_rng(2)
    embs = rng.normal(size=(25, 128)).astype(np.float32)
    entries = [(f"e{i}", rng.normal(size=(30, 3)).astype(np.float32), "A" * 30)
               for i in range(25)]
    prefix = str(tmp_path / "db")
    jax_codecs.write_pt_db(prefix, embs, entries)
    want = list(jax_codecs.FlatDB.open(prefix).iter_blocks(batch))
    got = list(t_codecs.FlatDB.open(prefix).iter_blocks(batch))
    assert [o for o, _ in got] == [o for o, _ in want] == list(range(0, 25, batch))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_write_ca_pdb_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    coords = rng.normal(size=(50, 3)).astype(np.float32) * 10
    seq = "ACDEFGHIKLMNPQRSTVWY" * 2 + "ACDEFGHIKX"
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = t_pdb.write_ca_pdb(str(tmp_path / "t"), coords, seq, name="s")
    want = jax_pdb.write_ca_pdb(str(tmp_path / "j"), coords, seq, name="s")
    assert got.endswith("s.pdb") and open(got).read() == open(want).read()
    d = t_pdb.read_ca(got)
    assert d["seq"] == seq
    np.testing.assert_allclose(d["coords"], coords, atol=2e-3)
    unnamed = t_pdb.write_ca_pdb(str(tmp_path / "t"), coords[:3], seq[:3])
    assert unnamed.endswith(".pdb") and unnamed != got
