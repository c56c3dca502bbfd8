"""The segmenter and the DB builder on the card against the port on the CPU.

Every test here carries the `gpu` marker and skips (decided at run time)
where there is no CUDA device. The file imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_segment_gpu.py

One seeded Merizo state dict (`init_state_dict(3)`) on both devices, float32
with TF32 off on the card: domain masks and background logits within 2e-3
(the IPA encoder's bound against the reference golden), domain ids equal,
per-residue confidences within 1e-3. Foldclass embeddings of a createdb
build within 1e-4, the port's Foldclass tolerance.

The batched segmenter on the card: chains batched by length bucket against
each chain alone (domain ids and ndom equal, confidences within 2e-4); a
padded forward with the lengths on the host runs without one host sync
(`torch.cuda.set_sync_debug_mode("error")`); the packed GRU keeps each
row's own final state, its rows sorted or not.
"""

import os

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.db.codecs import FlatDB
from merizo_search_tpu_torch.models.merizo import network as tnet
from merizo_search_tpu_torch.pipeline.createdb import run_createdb
from merizo_search_tpu_torch.pipeline.embed import load_foldclass_params
from merizo_search_tpu_torch.models.merizo.features import generate_features
from merizo_search_tpu_torch.models.merizo.gru import BiGRU
from merizo_search_tpu_torch.segment import pipeline
from merizo_search_tpu_torch.segment.pipeline import segment_structure, segment_structures
from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def backbones(tmp_path_factory):
    d = tmp_path_factory.mktemp("bb")
    rng = np.random.default_rng(6)
    paths = []
    for n in (64, 180, 300):
        paths.append(str(d / f"b{n}.pdb"))
        write_backbone_pdb(paths[-1], helical_backbone(rng, n), rng)
    return paths


def test_merizo_on_the_card_matches_the_cpu(cuda, backbones):
    sd = tnet.init_state_dict(3)
    models = {dev: tnet.model_from_state_dict(sd, dev) for dev in ("cpu", cuda)}
    for path in backbones:
        f = generate_features(path)
        x = [torch.from_numpy(f[k])[None] for k in ("s", "z", "r", "t", "ri")]
        x[1] = x[1][..., None]
        out = {dev: [y.cpu() for y in m.forward_features(*(v.to(dev) for v in x))]
               for dev, m in models.items()}
        for a, b in zip(out[cuda], out["cpu"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
    chains = ["A"] * len(backbones)
    res = {dev: segment_structures(m, backbones, chains, iterate=True)
           for dev, m in models.items()}
    for g, c in zip(res[cuda], res["cpu"]):
        np.testing.assert_array_equal(g["domain_ids"], c["domain_ids"])
        np.testing.assert_allclose(g["conf_res"], c["conf_res"], atol=1e-3)


def test_createdb_on_the_card_matches_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(9)
    src = tmp_path / "pdbs"
    src.mkdir()
    for i, n in enumerate(rng.integers(40, 400, 24)):
        write_backbone_pdb(str(src / f"p{i:02d}.pdb"), helical_backbone(rng, int(n)), rng)
    embs = {}
    for dev in ("cpu", cuda):
        prefix = str(tmp_path / str(dev) / "db")
        os.makedirs(os.path.dirname(prefix))
        run_createdb(str(src), prefix, fmt="mmap", model=load_foldclass_params(None, dev),
                     sidecar="int8")
        embs[dev] = np.asarray(FlatDB.open(prefix).embeddings())
    np.testing.assert_allclose(embs[cuda], embs["cpu"], atol=1e-4)


def test_batched_equals_one_chain_per_forward_on_the_card(cuda, tmp_path):
    """14 chains of 60-420 residues over six buckets, iterate on with
    domain_ave_size 100 (the subsets run alone at their exact length)."""
    rng = np.random.default_rng(12)
    paths = []
    for i, n in enumerate(rng.integers(60, 421, 14)):
        paths.append(str(tmp_path / f"c{i}.pdb"))
        write_backbone_pdb(paths[-1], helical_backbone(rng, int(n)), rng)
    model = tnet.model_from_state_dict(tnet.init_state_dict(3), cuda)
    kw = {"iterate": True, "domain_ave_size": 100}
    batched = segment_structures(model, paths, ["A"] * len(paths), **kw)
    for p, fb in zip(paths, batched):
        fs = segment_structure(model, p, **kw)
        np.testing.assert_array_equal(fb["domain_ids"], fs["domain_ids"])
        assert fb["ndom"] == fs["ndom"]
        np.testing.assert_allclose(fb["conf_res"], fs["conf_res"], rtol=0, atol=2e-4)


def test_a_batched_forward_never_waits_on_the_card(cuda, backbones):
    """The lengths come from the host, longest first: the GRUs pack without
    reading the mask back or copying a sort order, and the constant tables
    are on the card already, so no operation of the forward syncs. The
    result equals the call that reads the lengths back from the mask."""
    model = tnet.model_from_state_dict(tnet.init_state_dict(3), cuda)
    feats = sorted((generate_features(p) for p in backbones), key=lambda f: -f["nres"])
    x = [torch.from_numpy(a).to(cuda)
         for a in pipeline._padded_features(feats, feats[0]["nres"])]
    lens = torch.tensor([f["nres"] for f in feats])
    want = model.forward_features(*x)
    alone = model.forward_features(*(a[:1] for a in x[:5]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = model.forward_features(*x, lens)
        got_alone = model.forward_features(*(a[:1] for a in x[:5]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got + got_alone, want + alone):
        assert torch.equal(a, b)


def test_packed_gru_keeps_each_rows_state_on_the_card(cuda):
    torch.manual_seed(0)
    gru = BiGRU(8, 16).to(cuda)
    x = torch.randn(4, 30, 8, device=cuda)
    for lengths in ([30, 19, 7, 1], [7, 30, 1, 19]):
        with torch.no_grad():
            out, h = gru.run(x, torch.tensor(lengths))
            for b, n in enumerate(lengths):
                o1, h1 = gru.run(x[b:b + 1, :n])
                torch.testing.assert_close(out[b, :n], o1[0], rtol=0, atol=1e-5)
                torch.testing.assert_close(h[b], h1[0], rtol=0, atol=1e-5)
                assert not out[b, n:].any()
