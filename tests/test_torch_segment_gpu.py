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
"""

import os

import numpy as np
import pytest
import torch

from merizo_search_tpu_torch.db.codecs import FlatDB
from merizo_search_tpu_torch.models.merizo import network as tnet
from merizo_search_tpu_torch.pipeline.createdb import run_createdb
from merizo_search_tpu_torch.pipeline.embed import load_foldclass_params
from merizo_search_tpu_torch.segment.pipeline import segment_structures
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
    from merizo_search_tpu_torch.models.merizo.features import generate_features

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
