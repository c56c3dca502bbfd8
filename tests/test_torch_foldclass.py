"""The port's Foldclass embedder against the JAX package and the goldens.

Both packages get one state dict: the reference-named `sd.*` tensors of
tests/golden/foldclass.npz. Inputs are made with numpy and handed to both
as numpy; the port runs on the CPU. Tolerance: 1e-4 absolute (1e-3
relative), the bound tests/test_foldclass.py holds the JAX embedder to
against the same goldens -- both compute in float32 on the CPU, with
different summation orders.
"""

import os

import numpy as np
import pytest
import torch

from merizo_search_tpu.models import foldclass as jfc
from merizo_search_tpu.pipeline import embed as jembed
from merizo_search_tpu_torch.models import foldclass as tfc
from merizo_search_tpu_torch.pipeline import embed as tembed

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "foldclass.npz")
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def sd(golden):
    return {k[len("sd."):]: golden[k] for k in golden.files if k.startswith("sd.")}


@pytest.fixture(scope="module")
def jparams(sd):
    return jfc.params_from_torch_state_dict(sd)


@pytest.fixture(scope="module")
def model(sd):
    m = tfc.FoldClassNet()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m.eval()


def _embed(model, coords, mask=None):
    with torch.no_grad():
        return model(torch.from_numpy(coords),
                     None if mask is None else torch.from_numpy(mask)).numpy()


def test_state_dict_names_match_reference(sd):
    """The reference state dict loads as is: the same names and shapes."""
    want = {k: tuple(v.shape) for k, v in sd.items()}
    got = {k: tuple(v.shape) for k, v in tfc.FoldClassNet().state_dict().items()}
    assert got == want


@pytest.mark.parametrize("case", ["small", "mid", "large"])
def test_matches_goldens(golden, model, case):
    got = _embed(model, golden[f"coords_{case}"][None])[0]
    np.testing.assert_allclose(got, golden[f"emb_{case}"][0], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["small", "mid", "large"])
def test_matches_jax_embed(golden, jparams, model, case):
    coords = golden[f"coords_{case}"][None]
    want = np.asarray(jfc.embed(jparams, coords))
    np.testing.assert_allclose(_embed(model, coords), want, atol=ATOL, rtol=RTOL)


def test_matches_jax_on_padded_batch(golden, jparams, model):
    """Masked padding, batch of two, at a length whose pair stage runs in
    more than one row block."""
    n = 512
    assert tfc.choose_block(n) < n
    rng = np.random.default_rng(3)
    batch = np.zeros((2, n, 3), np.float32)
    mask = np.zeros((2, n), np.float32)
    for b, ln in enumerate((300, 500)):
        batch[b, :ln] = np.cumsum(rng.normal(size=(ln, 3)) * 2.2, axis=0)
        mask[b, :ln] = 1
    want = np.asarray(jfc.embed(jparams, batch, mask))
    np.testing.assert_allclose(_embed(model, batch, mask), want, atol=ATOL, rtol=RTOL)


def test_params_from_jax_round_trip(sd, jparams):
    """sd -> JAX pytree -> numpy -> params_from_jax gives back sd exactly."""
    as_np = {"pe": np.asarray(jparams["pe"]),
             "layers": [{k: {"w": np.asarray(v["w"]), "b": np.asarray(v["b"])}
                         for k, v in layer.items()} for layer in jparams["layers"]]}
    back = tfc.params_from_jax(as_np)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_params_from_jax_random_init_matches_jax(golden):
    """JAX's own random init converted into the port embeds identically."""
    import jax

    jp = jfc.init_params(jax.random.PRNGKey(1))
    m = tfc.FoldClassNet()
    m.load_state_dict(tfc.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    coords = golden["coords_mid"][None]
    np.testing.assert_allclose(_embed(m.eval(), coords),
                               np.asarray(jfc.embed(jp, coords)), atol=ATOL, rtol=RTOL)


def test_embed_structures_matches_jax(jparams, model):
    """Mixed lengths across four buckets: the port's bucketing and small-set
    merge against the JAX embed_structures."""
    rng = np.random.default_rng(7)
    lengths = [37, 64, 65, 150, 300]
    coords = [np.cumsum(rng.normal(size=(n, 3)) * 2.2, axis=0).astype(np.float32)
              for n in lengths]
    want = jembed.embed_structures(jparams, coords)
    got = tembed.embed_structures(model, coords)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # batches of two structures give the same embeddings
    got_b = tembed.embed_structures(model, coords, batch_budget=lambda b: 2)
    np.testing.assert_allclose(got_b, want, atol=ATOL, rtol=RTOL)


def test_load_foldclass_params_reads_state_dict(tmp_path, sd, model, golden):
    path = str(tmp_path / "foldclass.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    loaded = tembed.load_foldclass_params(path, device="cpu")
    coords = golden["coords_small"][None]
    np.testing.assert_array_equal(_embed(loaded, coords), _embed(model, coords))


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tembed.load_foldclass_params(None, device="cuda")
