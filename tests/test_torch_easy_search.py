"""The port's `easy-search` verb against the JAX package's.

Both CLIs get one Merizo weights directory (a seeded random state dict under
the reference's names, as in tests/test_torch_segment.py), one Foldclass
state dict (tests/golden/foldclass.npz) and the same synthetic multi-domain
chains (helical backbones from tools/synthetic.py). The DB holds the
domains the port's `segment --save_domains` cuts out of those chains
(`<chain>_merizo_NN`, so each chain's domains lie together) and 12
single-domain decoys; the port's `createdb` builds it. Both CLIs then run
`easy-search --multi_domain_search -d cpu --precision fp32` in each
multi-domain mode.

- `_segment.tsv`: equal but for the runtime column; confidences within
  1e-3 (as in tests/test_torch_segment.py).
- `_search.tsv` (with chopping / dom_conf / dom_plddt): equal, the domain
  confidence within 1e-3 and emb_score within 2e-4 (the fp32 tolerance of
  tests/test_torch_search.py: the embedders agree to ~1e-6 and the TSV
  rounds to 4 decimals).
- `_search_multi_dom.tsv`: the rows and categories equal, the pair scores
  within 1e-4.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from merizo_search_tpu import cli as jcli
from merizo_search_tpu_torch import cli as tcli
from merizo_search_tpu_torch.models.merizo import network as tnet
from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

CONF_TOL = 1e-3
SCORE_TOL = 2e-4
MD_TOL = 1e-4
LENGTHS = (260, 330, 180)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("easy_search")
    sd = tnet.init_state_dict(3)
    keys = sorted(sd)
    (d / "weights").mkdir()
    for i in range(3):
        torch.save({k: sd[k] for k in keys[i::3]}, str(d / "weights" / f"part{i}.pt"))
    z = np.load(os.path.join(os.path.dirname(__file__), "golden", "foldclass.npz"))
    torch.save({k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")},
               str(d / "foldclass.pt"))
    rng = np.random.default_rng(5)
    chains = []
    for i, n in enumerate(LENGTHS):
        chains.append(str(d / f"mdc{i}.pdb"))
        write_backbone_pdb(chains[-1], helical_backbone(rng, n), rng)
    tcli.main(["segment", *chains, str(d / "seg" / "s"), "-d", "cpu", "--save_domains",
               "--merizo_weights", str(d / "weights"), "--merizo_output", str(d / "seg")])
    (d / "dbin").mkdir()
    taken = []
    for f in sorted(glob.glob(str(d / "seg" / "*.dom_pdb"))):
        shutil.copy(f, str(d / "dbin" / (os.path.basename(f)[:-len(".dom_pdb")] + ".pdb")))
        with open(f) as fh:
            taken.append(sum(" CA " in ln for ln in fh))
    # With random weights an embedding is nearly a function of the chain's
    # length, so entries of near-equal lengths tie to ~1e-6 for every query
    # and the two packages may order them either way: the decoys' lengths
    # stay 6 or more residues from every other entry's.
    lengths = []
    for n in range(60, 400, 6):
        if all(abs(n - m) >= 6 for m in taken + lengths) and len(lengths) < 12:
            lengths.append(n)
    for i, n in enumerate(lengths):
        write_backbone_pdb(str(d / "dbin" / f"dec{i:02d}x.pdb"), helical_backbone(rng, n), rng)
    tcli.main(["createdb", str(d / "dbin"), str(d / "db"), "-d", "cpu",
               "--weights", str(d / "foldclass.pt")])
    return d, chains


def _rows(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def _close(t, j, cols):
    """Rows equal except the numeric columns `cols` {index: tolerance}."""
    assert len(t) == len(j)
    for c, (a, b) in enumerate(zip(t, j)):
        if c in cols:
            assert abs(float(a) - float(b)) <= cols[c], (c, a, b)
        else:
            assert a == b, (c, a, b)


@pytest.mark.parametrize("mode", ["exhaustive_tmalign", "embscore"])
def test_easy_search_cli_matches_jax(setup, mode):
    d, chains = setup
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        o = d / f"{pkg}_{mode}"
        main(["easy-search", *chains, str(d / "db"), str(o / "res"), "-d", "cpu",
              "--precision", "fp32", "-k", "5", "--output_headers",
              "--weights", str(d / "foldclass.pt"), "--merizo_weights", str(d / "weights"),
              "--merizo_output", str(o), "--multi_domain_search",
              "--multi_domain_mode", mode])
        out[pkg] = {s: _rows(str(o / f"res_{s}.tsv"))
                    for s in ("segment", "search", "search_multi_dom")}
    seg_t, seg_j = out["port"]["segment"], out["jax"]["segment"]
    assert len(seg_t) == len(seg_j) == len(LENGTHS) + 1 and seg_t[0] == seg_j[0]
    for t, j in zip(seg_t[1:], seg_j[1:]):
        _close(t[:6] + t[7:], j[:6] + j[7:], {5: CONF_TOL})
    assert sum(int(r[4]) >= 2 for r in seg_t[1:]) == len(LENGTHS)

    s_t, s_j = out["port"]["search"], out["jax"]["search"]
    assert s_t[0] == s_j[0] and s_t[0][1:4] == ["chopping", "dom_conf", "dom_plddt"]
    assert len(s_t) == len(s_j) > 1
    for t, j in zip(s_t[1:], s_j[1:]):
        _close(t, j, {2: CONF_TOL, 6: SCORE_TOL})
    # every domain's first hit is itself
    first = {}
    for r in s_t[1:]:
        first.setdefault(r[0], r)
    assert all(r[5] == q and float(r[13]) >= 0.99 for q, r in first.items())

    m_t, m_j = out["port"]["search_multi_dom"], out["jax"]["search_multi_dom"]
    assert m_t[0] == m_j[0] and len(m_t) == len(m_j) > 1
    for t, j in zip(m_t[1:], m_j[1:]):
        assert t[:5] + t[6:] == j[:5] + j[6:]
        ti, ji = [f.split(":") for f in t[5].split(",")], [f.split(":") for f in j[5].split(",")]
        assert [x[:2] for x in ti] == [x[:2] for x in ji]
        np.testing.assert_allclose([float(x[2]) for x in ti], [float(x[2]) for x in ji],
                                   atol=MD_TOL)
    # every chain finds itself as an exact multi-domain match
    selves = {r[0] for r in m_t[1:] if r[2] == r[0] + "_merizo" and r[4] == "3"}
    assert selves == {f"mdc{i}" for i in range(len(LENGTHS))}


def test_easy_search_stops_after_an_empty_segmentation(setup, tmp_path, monkeypatch):
    """A segmentation that yields no domain (the segmenter replaced by one
    that finds none in the chain): both CLIs write the segment TSV and stop
    before the search stage."""
    from merizo_search_tpu.segment import outputs as jout
    from merizo_search_tpu_torch.segment import outputs as tout

    d, chains = setup
    row = {"name": chains[-1], "length": 180, "nres_domain": 0, "nres_non_domain": 180,
           "num_domains": 0, "conf": 0.0, "time": 0.5, "dom_str": ""}
    for mod in (jout, tout):
        monkeypatch.setattr(mod, "run_merizo", lambda *a, **kw: ([], [row]))
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / pkg / "res"
        main(["easy-search", chains[-1], str(d / "db"), str(out), "-d", "cpu",
              "--merizo_weights", str(d / "weights"), "--merizo_output", str(tmp_path / pkg)])
        assert _rows(str(out) + "_segment.tsv") == [
            ["mdc2", "180", "0", "180", "0", "0.0000", "0.5000", ""]]
        assert not os.path.exists(str(out) + "_search.tsv")


def test_trace_writes_a_chrome_trace(setup, tmp_path):
    d, chains = setup
    tcli.main(["segment", chains[-1], str(tmp_path / "seg"), "-d", "cpu",
               "--merizo_weights", str(d / "weights"), "--merizo_output", str(tmp_path),
               "--trace", str(tmp_path / "trace")])
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
