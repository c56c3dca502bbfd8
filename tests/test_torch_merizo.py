"""The port's Merizo network against the golden and the JAX package.

- The golden (tests/golden/merizo.npz: the reference model's own state dict
  `sd.*` and its outputs on one 432-residue chain) with the bounds of
  tests/test_merizo_model.py: ALiBi within 1e-5, the IPA encoder within
  2e-3 absolute and 2e-4 mean, domain ids exact, confidences within 1e-3.
- The JAX package on one synthetic backbone (numpy, from a seed) with one
  set of weights: the JAX init of PRNGKey(1) with its four IPA output
  projections redrawn non-zero (its init zeroes them, which would leave the
  attention unchecked), carried over by `params_from_jax`. Domain masks
  within 2e-3 (the encoder's bound), domain ids exact, confidences within
  1e-3; padded inputs with a mask agree with the unpadded ones on the
  valid rows within the same bounds.
"""

import os

import jax
import numpy as np
import pytest
import torch

from merizo_search_tpu.models.merizo import decoder as jdec
from merizo_search_tpu.models.merizo import network as jnet
from merizo_search_tpu.models.merizo.features import generate_features as jax_features
from merizo_search_tpu.ops.gru import bigru, gru_params_from_torch
from merizo_search_tpu_torch.models.merizo import decoder as tdec
from merizo_search_tpu_torch.models.merizo import ipa as tipa
from merizo_search_tpu_torch.models.merizo import network as tnet
from merizo_search_tpu_torch.models.merizo.features import generate_features
from merizo_search_tpu_torch.models.merizo.gru import BiGRU
from merizo_search_tpu_torch.segment.pipeline import _ids_from_network
from merizo_search_tpu_torch.tools.synthetic import helical_backbone, write_backbone_pdb

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "merizo.npz")
DM_TOL = 2e-3
CONF_TOL = 1e-3


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
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("merizo golden not generated (tools/make_goldens.py)")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden_sd(golden):
    return {k[len("sd."):]: golden[k] for k in golden.files if k.startswith("sd.")}


@pytest.fixture(scope="module")
def golden_model(golden_sd):
    return tnet.model_from_state_dict(golden_sd, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _confidence(model, dm, dom_ids):
    """Per-residue confidence as the segment pipeline computes it."""
    conf = np.zeros(len(dom_ids), np.float32)
    ids = np.unique(dom_ids[dom_ids != 0])
    if len(ids):
        sel_idx, sel_mask = tdec.compact_domain_selection(dom_ids, ids)
        c = model.domain_confidence(dm, _t(sel_idx), _t(sel_mask)).numpy()
        for j, d in enumerate(ids):
            conf[dom_ids == d] = c[j]
    return conf


def test_alibi_matches_the_golden(golden):
    got = tnet.alibi_bias(_t(golden["ri"])).numpy()
    np.testing.assert_allclose(got, golden["alibi_bias"], atol=1e-5)


def test_ipa_encoder_matches_the_golden(golden, golden_model):
    with torch.no_grad():
        s = golden_model.linear_s_in(_t(golden["s"]))
        z = golden_model.linear_z_in(_t(golden["z"]))
        got = golden_model.ipa(s, z, _t(golden["r"]), _t(golden["t"])).numpy()
    want = golden["ipa_out"]
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.abs(got - want).mean() < 2e-4


def test_forward_matches_the_golden(golden, golden_model):
    dm, bg = golden_model.forward_features(*(_t(golden[k]) for k in ("s", "z", "r", "t", "ri")))
    dom_ids = _ids_from_network(dm[0].numpy(), bg[0].numpy())
    np.testing.assert_array_equal(dom_ids, golden["dom_ids"])
    np.testing.assert_allclose(_confidence(golden_model, dm, dom_ids), golden["conf_res"],
                               atol=CONF_TOL)


def test_the_reference_state_dict_loads_by_name(golden_sd):
    """Every MerizoNet entry comes from the reference's state dict under its
    own name; the reference's unused modules are the only keys left over."""
    model_keys = set(tnet.MerizoNet().state_dict())
    assert model_keys <= set(golden_sd)
    left = {k.rsplit(".", 1)[0].split(".")[1] for k in set(golden_sd) - model_keys}
    assert left == {"conf_gru_all", "conf_out_all", "ipa"}      # ipa.ipa.rotary_emb
    with pytest.raises(KeyError):
        tnet.model_from_state_dict({k: v for k, v in golden_sd.items()
                                    if "bg_gru" not in k})


@pytest.fixture(scope="module")
def jparams():
    p = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init_params)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    for name in ("pair_out", "hidden_out", "points_out", "points_norm_out"):
        w = p["ipa"]["ipa"][name]["w"]
        p["ipa"]["ipa"][name]["w"] = (rng.normal(size=w.shape) / np.sqrt(w.shape[0])
                                      ).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def model(jparams):
    return tnet.model_from_state_dict(tnet.params_from_jax(jparams), "cpu")


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("merizo") / "bb.pdb")
    rng = np.random.default_rng(8)
    write_backbone_pdb(path, helical_backbone(rng, 100), rng)
    return path, generate_features(path)


def test_features_match_jax(feats):
    path, f = feats
    want = jax_features(path)
    assert f["nres"] == want["nres"] == 100 and f["seq"] == want["seq"]
    for k in ("s", "z", "r", "t", "ri", "b"):
        assert f[k].dtype == want[k].dtype and np.array_equal(f[k], want[k]), k
    assert f["pdb"].tobytes() == want["pdb"].tobytes()


def _inputs(f, n_pad=None):
    """[1, n_pad] network inputs and mask, padded as the JAX segmenter pads."""
    n = f["nres"]
    n_pad = n_pad or n
    s = np.zeros((1, n_pad, 20), np.float32)
    z = np.zeros((1, n_pad, n_pad, 1), np.float32)
    r = np.tile(np.eye(3, dtype=np.float32), (1, n_pad, 1, 1))
    t = np.zeros((1, n_pad, 3), np.float32)
    ri = np.zeros((1, n_pad), np.float32)
    mask = np.zeros((1, n_pad), np.float32)
    s[0, :n], z[0, :n, :n, 0], r[0, :n] = f["s"], f["z"], f["r"]
    t[0, :n], ri[0, :n], mask[0, :n] = f["t"], f["ri"], 1.0
    return s, z, r, t, ri, mask


@pytest.fixture(scope="module")
def jax_out(jparams, feats):
    _, f = feats
    dm, bg = jnet.forward_features(jparams, *_inputs(f))
    dm, bg = np.asarray(dm), np.asarray(bg)
    dom_ids = _ids_from_network(dm[0], bg[0])
    ids = np.unique(dom_ids[dom_ids != 0])
    sel_idx, sel_mask = jdec.compact_domain_selection(dom_ids, ids)
    conf = np.asarray(jnet.domain_confidence(jparams["decoder"], dm, sel_idx, sel_mask))
    return dm, bg, dom_ids, conf


def test_forward_and_confidence_match_jax(model, jparams, feats, jax_out):
    _, f = feats
    jdm, jbg, jids, jconf = jax_out
    s, z, r, t, ri, _ = _inputs(f)
    dm, bg = model.forward_features(_t(s), _t(z), _t(r), _t(t), _t(ri))
    np.testing.assert_allclose(dm.numpy(), jdm, atol=DM_TOL)
    np.testing.assert_allclose(bg.numpy(), jbg, atol=DM_TOL)
    dom_ids = _ids_from_network(dm[0].numpy(), bg[0].numpy())
    np.testing.assert_array_equal(dom_ids, jids)
    ids = np.unique(dom_ids[dom_ids != 0])
    sel_idx, sel_mask = tdec.compact_domain_selection(dom_ids, ids)
    conf = model.domain_confidence(dm, _t(sel_idx), _t(sel_mask)).numpy()
    np.testing.assert_allclose(conf, jconf, atol=CONF_TOL)
    # domains of unequal, interleaved lengths, on the same domain masks
    split = np.repeat([1, 2, 3, 0, 2], [30, 11, 27, 7, 25])
    ids = np.array([1, 2, 3])
    sel_idx, sel_mask = tdec.compact_domain_selection(split, ids)
    conf = model.domain_confidence(dm, _t(sel_idx), _t(sel_mask)).numpy()
    want = jnet.domain_confidence(jparams["decoder"], jdm, sel_idx, sel_mask)
    np.testing.assert_allclose(conf, np.asarray(want), atol=CONF_TOL)


def test_padded_inputs_with_a_mask_match_jax_and_the_unpadded_run(model, jparams, feats,
                                                                   jax_out):
    """The mask path: the IPA's INF * (m_i m_j - 1) term, the decoder's mask
    and the GRUs packed at the valid length."""
    _, f = feats
    n = f["nres"]
    padded = _inputs(f, 128)
    jdm, jbg = (np.asarray(x) for x in jnet.forward_features(jparams, *padded))
    dm, bg = model.forward_features(*(_t(x) for x in padded))
    np.testing.assert_allclose(dm.numpy()[0, :n], jdm[0, :n], atol=DM_TOL)
    np.testing.assert_allclose(bg.numpy()[0, :n], jbg[0, :n], atol=DM_TOL)
    np.testing.assert_allclose(dm.numpy()[0, :n], jax_out[0][0], atol=DM_TOL)
    np.testing.assert_array_equal(_ids_from_network(dm[0, :n].numpy(), bg[0, :n].numpy()),
                                  jax_out[2])


def test_params_from_jax_inverts_params_from_torch_state_dict(jparams, golden_sd):
    sd = tnet.params_from_jax(jparams)
    want = tnet.MerizoNet().state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape and sd[k].dtype == torch.float32 for k in sd)
    back = jnet.params_from_torch_state_dict(sd)
    flat_a, tree_a = jax.tree_util.tree_flatten(back)
    flat_b, tree_b = jax.tree_util.tree_flatten(jparams)
    assert tree_a == tree_b
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(flat_a, flat_b))
    # and the other way round, on the reference's own state dict
    sd2 = tnet.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jnet.params_from_torch_state_dict(golden_sd)))
    for k, v in sd2.items():
        assert np.array_equal(v.numpy(), golden_sd[k]), k


def test_seeded_default_is_fixed_and_complete():
    a, b = tnet.init_state_dict(), tnet.init_state_dict()
    assert sorted(a) == sorted(tnet.MerizoNet().state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ipa.ipa.hidden_out.weight"], tnet.init_state_dict(1)[
        "ipa.ipa.hidden_out.weight"])
    assert float(a["ipa.ipa.hidden_out.weight"].abs().max()) > 0
    model = tnet.load_merizo_params(None, "cpu")
    assert all(torch.equal(v, a[k]) for k, v in model.state_dict().items())


def test_rotary_matches_the_published_definition():
    """The rotary tables against tests/test_rotary_convention.py's
    complex-multiplication form of RoFormer eq. 34, positions on the head
    axis (the reference's quirk)."""
    from tests.test_rotary_convention import rotary_complex

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, tipa.N_HEADS, tipa.C_HIDDEN)).astype(np.float32)
    got = tipa.rotary(_t(x)).numpy()
    want = rotary_complex(x, rot_dim=tipa.C_HIDDEN // 2, seq_dim=-2)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-5)


def test_gru_at_unequal_lengths_matches_the_masked_jax_gru():
    """Packed sequences against JAX `bigru` with masks: outputs on the valid
    steps and the top layer's reverse final state, within 1e-5."""
    torch.manual_seed(0)
    gru = BiGRU(6, 5)
    sd = {f"g.{k}": v.detach().numpy() for k, v in gru.state_dict().items()}
    jp = gru_params_from_torch(sd, "g", 2)
    rng = np.random.default_rng(3)
    lengths = np.array([17, 9, 1])
    x = rng.normal(size=(3, 17, 6)).astype(np.float32)
    mask = (np.arange(17)[None, :] < lengths[:, None]).astype(np.float32)
    jout, jh = (np.asarray(a) for a in bigru(jp, x, mask))
    with torch.no_grad():
        out, h = gru.run(_t(x), _t(lengths))
    out = out.numpy()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(out[b, :n], jout[b, :n], atol=1e-5)
        assert not out[b, n:].any()
    np.testing.assert_allclose(h.numpy(), jh, atol=1e-5)
