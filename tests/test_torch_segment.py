"""The port's `segment` verb against the JAX package's.

Both CLIs read one weights directory of `.pt` shards (a seeded random
state dict under the reference's names, seed 3: it cuts the 430-residue
chain into several domains, and `--iterate` re-segments the largest) and
the same synthetic backbone PDBs (compact helical domains, numpy from a
seed). The `_segment.tsv` rows must agree in name, nres, domain residues,
ndom and chopping, with the confidence column within 1e-3 (runtime is wall
time); every `.pdb2`, `.fasta` and `.dom_pdb` file byte for byte, and the
`.domains` rows field by field with the confidence within 1e-3.
"""

import os

import numpy as np
import pytest
import torch

from merizo_search_tpu import cli as jcli
from merizo_search_tpu_torch import cli as tcli
from merizo_search_tpu_torch.models.merizo import network as tnet
from merizo_search_tpu_torch.segment.pipeline import segment_structure, segment_structures
from merizo_search_tpu_torch.segment.postprocess import format_dom_str
from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb
from merizo_search_tpu_torch.utils import profiling

CONF_TOL = 1e-3
LENGTHS = (70, 110, 128, 430)


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
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("segment")
    sd = tnet.init_state_dict(3)
    keys = sorted(sd)
    (d / "weights").mkdir()
    for i in range(3):                     # split three ways, as the reference ships them
        torch.save({k: sd[k] for k in keys[i::3]}, str(d / "weights" / f"part{i}.pt"))
    rng = np.random.default_rng(1)
    paths = []
    for n in LENGTHS:
        paths.append(str(d / f"s{n}.pdb"))
        write_backbone_pdb(paths[-1], helical_backbone(rng, n), rng)
    return d, paths, tnet.model_from_state_dict(sd, "cpu")


def _rows(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def test_segment_cli_matches_jax(inputs):
    d, paths, _ = inputs
    flags = ["-d", "cpu", "--iterate", "--save_pdb", "--save_domains", "--save_fasta",
             "--merizo_weights", str(d / "weights"), "--output_headers"]
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        main(["segment", *paths, str(d / pkg / "seg"), *flags,
              "--merizo_output", str(d / pkg)])
    jrows, trows = (_rows(str(d / pkg / "seg_segment.tsv")) for pkg in ("jax", "port"))
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == len(LENGTHS) + 1
    for t, j in zip(trows[1:], jrows[1:]):
        # name, nres, nres_dom, nres_ndr, ndom and the chopping equal
        assert t[:5] + t[7:] == j[:5] + j[7:]
        assert abs(float(t[5]) - float(j[5])) <= CONF_TOL
    assert [int(r[1]) for r in trows[1:]] == list(LENGTHS)
    assert int(trows[-1][4]) >= 3                       # the 430-residue chain is multi-domain
    files = sorted(os.listdir(d / "jax"))
    assert sorted(os.listdir(d / "port")) == files
    assert any(f.endswith(".dom_pdb") for f in files) and any(f.endswith(".fasta") for f in files)
    for f in files:
        if f.endswith("_segment.tsv"):
            continue
        jb, tb = (open(d / pkg / f, "rb").read() for pkg in ("jax", "port"))
        if not f.endswith(".domains"):
            assert tb == jb, f
            continue
        for t, j in zip(tb.decode().splitlines(), jb.decode().splitlines(), strict=True):
            t, j = t.split("\t"), j.split("\t")
            assert t[:3] + t[4:] == j[:3] + j[4:]
            assert abs(float(t[3]) - float(j[3])) <= CONF_TOL


def test_iterate_resegments_the_long_chain(inputs):
    """--iterate runs the network again on the oversized domains (one call
    each) and changes the chopping."""
    _, paths, model = inputs
    calls = []
    for iterate in (False, True):
        profiling.reset()
        f = segment_structure(model, paths[-1], iterate=iterate)
        calls.append((profiling.timings()["segment.network"][1],
                      format_dom_str(f["domain_ids"], f["ri"])))
    assert calls[0][0] == 1 and calls[1][0] > 1
    assert calls[1][1] != calls[0][1]


def test_batched_equals_single(inputs):
    _, paths, model = inputs
    batched = segment_structures(model, paths, ["A"] * len(paths), iterate=True)
    for p, fb in zip(paths, batched):
        fs = segment_structure(model, p, iterate=True)
        np.testing.assert_array_equal(fb["domain_ids"], fs["domain_ids"])
        np.testing.assert_array_equal(fb["conf_res"], fs["conf_res"])
        assert fb["ndom"] == fs["ndom"]


def test_oversize_chain_raises_alone_and_is_skipped_among_others(inputs, tmp_path):
    _, paths, model = inputs
    rng = np.random.default_rng(2)
    big = str(tmp_path / "big.pdb")
    write_backbone_pdb(big, helical_backbone(rng, 3073), rng)
    with pytest.raises(ValueError, match="3073 residues exceeds the 3072-residue"):
        segment_structure(model, big)
    with pytest.raises(ValueError, match="3073 residues exceeds the 3072-residue"):
        segment_structures(model, [big], ["A"])
    res = segment_structures(model, [big, paths[0]], ["A", "A"])
    assert res[0] is None and res[1]["nres"] == LENGTHS[0]


def test_bad_pdb_chain_raises(inputs, tmp_path):
    d, paths, _ = inputs
    with pytest.raises(ValueError, match="Chain 'B' not present"):
        tcli.main(["segment", paths[0], str(tmp_path / "out"), "-d", "cpu", "--pdb_chain", "B",
                   "--merizo_weights", str(d / "weights"), "--merizo_output", str(tmp_path)])
