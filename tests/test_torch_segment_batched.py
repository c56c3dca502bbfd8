"""The port's batched segmenter: chains grouped by length bucket, up to
`batch_size(bucket)` of them in one Merizo forward.

One weights directory of `.pt` shards (`init_state_dict(3)`, as
tests/test_torch_segment.py writes it) and synthetic helical backbones from
a numpy seed, at lengths over four buckets (64, 128, 192, 256). The pair
budget is lowered so that at these sizes the 128 bucket holds more chains
than one batch takes.

- batched against each chain alone: domain ids and ndom equal,
  confidences within 2e-4 (the JAX package's bound for its own batched
  path, tests/test_segment_e2e.py), iterate off and on;
- the port's batched run against the JAX `segment_structures` on the same
  files and weights: domain ids equal, confidences within 1e-3;
- one `forward_features` call a batch, sum over buckets of
  ceil(n_bucket / bsz);
- a file that cannot be featurised gives None at its index and leaves the
  others as they were;
- the GRUs with lengths from the host, packed and unpacked.
"""

import numpy as np
import pytest
import torch

from merizo_search_tpu.models.merizo.network import load_merizo_params as jax_params
from merizo_search_tpu.segment.pipeline import segment_structures as jax_segment_structures
from merizo_search_tpu_torch.models.merizo import gru as tgru
from merizo_search_tpu_torch.models.merizo import network as tnet
from merizo_search_tpu_torch.models.merizo.features import generate_features
from merizo_search_tpu_torch.segment import pipeline
from merizo_search_tpu_torch.segment.pipeline import segment_structure, segment_structures
from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb
from merizo_search_tpu_torch.utils.bucketing import bucket_for

BATCH_TOL = 2e-4
CONF_TOL = 1e-3
# buckets 64 (3 chains), 128 (4), 192 (2), 256 (1)
LENGTHS = (45, 128, 58, 96, 181, 64, 80, 110, 150, 230)
# bsz: 64 -> 12, 128 -> 3, 192 and 256 -> 1
LOW_BUDGET = 3 * 128 * 128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads a test process (six run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("segment_batched")
    sd = tnet.init_state_dict(3)
    keys = sorted(sd)
    (d / "weights").mkdir()
    for i in range(3):
        torch.save({k: sd[k] for k in keys[i::3]}, str(d / "weights" / f"part{i}.pt"))
    rng = np.random.default_rng(4)
    paths = []
    for i, n in enumerate(LENGTHS):
        paths.append(str(d / f"c{i}_{n}.pdb"))
        write_backbone_pdb(paths[-1], helical_backbone(rng, n), rng)
    return d, paths, tnet.model_from_state_dict(sd, "cpu")


@pytest.fixture
def low_budget(monkeypatch):
    monkeypatch.setattr(pipeline, "PAIR_BUDGET", LOW_BUDGET)


def _expected_forwards(lengths):
    per_bucket = {}
    for n in lengths:
        per_bucket[bucket_for(n)] = per_bucket.get(bucket_for(n), 0) + 1
    return sum(-(-k // pipeline.batch_size(b)) for b, k in per_bucket.items())


@pytest.mark.parametrize("iterate", [False, True])
def test_batched_equals_one_chain_alone(inputs, low_budget, iterate):
    """domain_ave_size 40 makes every chain over 80 residues re-segment its
    oversized domains (one forward each, at the subset's exact length)."""
    _, paths, model = inputs
    assert pipeline.batch_size(128) == 3 and pipeline.batch_size(64) == 12
    kw = {"iterate": iterate, "domain_ave_size": 40}
    batched = segment_structures(model, paths, ["A"] * len(paths), **kw)
    assert [f["nres"] for f in batched] == list(LENGTHS)
    for p, fb in zip(paths, batched):
        fs = segment_structure(model, p, **kw)
        np.testing.assert_array_equal(fb["domain_ids"], fs["domain_ids"])
        assert fb["ndom"] == fs["ndom"]
        np.testing.assert_allclose(fb["conf_res"], fs["conf_res"], rtol=0, atol=BATCH_TOL)
    assert max(f["ndom"] for f in batched) >= 2


def test_batched_matches_jax_segment_structures(inputs):
    """Both packages at their own default budget (so both put the same
    chains in one batch; JAX pads to the bucket and a power of two)."""
    d, paths, model = inputs
    chains = ["A"] * len(paths)
    want = jax_segment_structures(jax_params(str(d / "weights")), paths, chains)
    got = segment_structures(model, paths, chains)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["domain_ids"], w["domain_ids"])
        assert g["ndom"] == w["ndom"]
        np.testing.assert_allclose(g["conf_res"], w["conf_res"], rtol=0, atol=CONF_TOL)


def _count_forwards(monkeypatch, model):
    calls = []
    forward = model.forward_features

    def counted(s, *a):
        calls.append(s.shape[0])
        return forward(s, *a)

    monkeypatch.setattr(model, "forward_features", counted)
    return calls


@pytest.mark.parametrize("budget", [LOW_BUDGET, pipeline.PAIR_BUDGET])
def test_one_forward_per_batch(inputs, monkeypatch, budget):
    _, paths, model = inputs
    monkeypatch.setattr(pipeline, "PAIR_BUDGET", budget)
    calls = _count_forwards(monkeypatch, model)
    confidences = []
    conf = model.domain_confidence
    monkeypatch.setattr(model, "domain_confidence",
                        lambda *a: confidences.append(1) or conf(*a))
    segment_structures(model, paths, ["A"] * len(paths))
    assert len(calls) == _expected_forwards(LENGTHS)
    assert sum(calls) == len(LENGTHS)
    # one confidence call a batch, every domain of its chains at once
    assert len(confidences) <= len(calls)
    if budget == LOW_BUDGET:
        assert sorted(calls) == [1, 1, 1, 1, 3, 3]   # 128: 3 + 1; 64: 3; 192: 1 + 1; 256: 1
    else:
        assert len(calls) == 4                        # one a bucket


def test_unreadable_file_is_none_among_several(inputs, tmp_path, low_budget):
    _, paths, model = inputs
    bad = tmp_path / "bad.pdb"
    bad.write_text("HEADER    NOT A STRUCTURE\nEND\n")
    missing = str(tmp_path / "missing.pdb")
    chosen = paths[1:6]
    res = segment_structures(model, [str(bad), *chosen, missing], ["A"] * (len(chosen) + 2))
    assert res[0] is None and res[-1] is None
    want = segment_structures(model, chosen, ["A"] * len(chosen))
    for g, w in zip(res[1:-1], want):
        np.testing.assert_array_equal(g["domain_ids"], w["domain_ids"])
        np.testing.assert_array_equal(g["conf_res"], w["conf_res"])
    with pytest.raises(ValueError, match="not present"):
        segment_structures(model, [str(bad)], ["A"])


def _gru_alone(gru, x, n):
    with torch.no_grad():
        return gru.run(x[None, :n])


@pytest.mark.parametrize("lengths", [[17, 12, 9, 1], [3, 17, 17, 9], [17, 17, 17, 17]],
                         ids=["sorted", "unsorted", "full"])
def test_gru_with_host_lengths(monkeypatch, lengths):
    """Each row against itself alone at its exact length: outputs on the
    valid steps and the reverse final state are the row's own (packing
    sorts the batch, sorted or not); rows past a length are zero. A full
    batch takes the unpacked branch, equal to lengths=None bit for bit."""
    torch.manual_seed(0)
    gru = tgru.BiGRU(6, 5)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 17, 6)).astype(np.float32))
    host = torch.tensor(lengths)
    packs = []
    pack = tgru.pack_padded_sequence
    monkeypatch.setattr(tgru, "pack_padded_sequence",
                        lambda *a, **kw: packs.append(kw["enforce_sorted"]) or pack(*a, **kw))
    with torch.no_grad():
        out, h = gru.run(x, host)
    for b, n in enumerate(lengths):
        o1, h1 = _gru_alone(gru, x[b], n)
        np.testing.assert_allclose(out[b, :n].numpy(), o1[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(h[b].numpy(), h1[0].numpy(), atol=1e-6)
        assert not out[b, n:].any()
    if min(lengths) == 17:
        assert packs == []
        with torch.no_grad():
            ref = gru.run(x)
        assert torch.equal(out, ref[0]) and torch.equal(h, ref[1])
    else:
        assert packs == [lengths == sorted(lengths, reverse=True)]


def test_forward_with_host_lengths_equals_the_masks(inputs):
    """forward_features with the lengths given equals the call that reads
    them back from the mask, bit for bit, on a padded batch of three."""
    _, paths, model = inputs
    feats = sorted((generate_features(p) for p in paths[:3]), key=lambda f: -f["nres"])
    x = [torch.from_numpy(a) for a in pipeline._padded_features(feats, feats[0]["nres"])]
    lens = torch.tensor([f["nres"] for f in feats])
    got = model.forward_features(*x, lens)
    want = model.forward_features(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # padding rows: identity frames, zero translation, residue index and mask
    r, t, ri, mask = x[2:]
    n = feats[-1]["nres"]
    assert torch.equal(r[-1, n:], torch.eye(3).expand(len(r[-1, n:]), 3, 3))
    assert not t[-1, n:].any() and not ri[-1, n:].any() and not mask[-1, n:].any()
    assert mask.sum(1).long().tolist() == lens.tolist()
