"""Phase C's block-major launch (ops/gather.py `gather_block_scores_by_block`,
the IVF's probe gather and rerank) on the CPU.

- The plain inversion (`invert_plain`, what the card's counting sort builds)
  against a brute-force loop over bidx, on lists with padding, a block that
  every query selects, blocks that no query selects, ids past the DB, Q not
  a multiple of 8 and KB not a multiple of the per-query f32 kernel's GROUP.
- The block-major entry against `gather_plain` (CPU tensors run it; equal
  arrays) in every dtype and scale mode, and against the JAX package's
  `gather_block_scores` in interpret mode (the function the JAX IVF runs
  there), with the tolerances of tests/test_torch_scan.py: 1e-5 absolute
  for f32 and bf16 (both sides sum 128 products of unit-norm rows, the port
  in float64, JAX in float32), int8 exact.
- The IVF's int8 probe passes the block-uniform scales in the per-row
  mode: the same scores, bit for bit, as the per-selected-block mode.

The card's side (bit equality with the per-query kernel, the card's CSR
against `invert_plain`) is in tests/test_torch_ivf_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merizo_search_tpu.ops import pallas_scan as jps
from merizo_search_tpu_torch.ops import gather, topk
from merizo_search_tpu_torch.ops.fused_scan import selected_scales
from merizo_search_tpu_torch.utils.profiling import counter

NEG_CAP = np.float32(-3.4e38)
# csrc/gather.cuh F32_GROUP: selected columns a CTA of the per-query f32
# kernel (the bf16/int8 per-query kernel takes one column a CTA, so any KB
# fits it; a KB that is no multiple of 4 still leaves the f32 grid a partial
# last group, and the inversion's lists odd lengths)
GROUP = 4


def _brute_inversion(bidx, nb):
    qn, kb = bidx.shape
    blocks = sorted({int(b) for b in bidx.flatten() if 0 <= b < nb})
    offsets, slots = [], []
    for b in blocks:
        row = [len(slots)]
        for r in range(8):
            slots += [q * kb + c for q in range(qn) for c in range(kb)
                      if bidx[q, c] == b and q % 8 == r]
            row.append(len(slots))
        offsets.append(row)
    pad = [q * kb + c for q in range(qn) for c in range(kb) if not 0 <= bidx[q, c] < nb]
    return blocks, offsets, slots, pad


def _case(name):
    rng = np.random.default_rng(31)
    nb = 40
    if name == "padding":
        bidx = rng.integers(-1, nb, (13, 7))
    elif name == "one_block_in_every_query":
        bidx = rng.integers(0, nb, (24, 5))
        bidx[:, 2] = 17
    elif name == "blocks_selected_by_none":
        nb = 1000
        bidx = rng.integers(0, 6, (9, 3)) * 97
    elif name == "q_not_a_multiple_of_8":
        bidx = rng.integers(0, 8, (11, 4))
    elif name == "kb_not_a_multiple_of_group":
        bidx = rng.integers(-1, 12, (16, 2 * GROUP + 3))
    elif name == "ids_past_the_db":
        bidx = rng.integers(-3, nb + 5, (10, 6))
    return bidx.astype(np.int32), nb


@pytest.mark.parametrize("case", ["padding", "one_block_in_every_query",
                                  "blocks_selected_by_none", "q_not_a_multiple_of_8",
                                  "kb_not_a_multiple_of_group", "ids_past_the_db"])
def test_plain_inversion_matches_brute_force(case):
    bidx, nb = _case(case)
    blocks, offsets, slots, pad = gather.invert_plain(torch.from_numpy(bidx), nb)
    want = _brute_inversion(bidx, nb)
    assert blocks.tolist() == want[0]
    assert offsets.tolist() == want[1]
    assert slots.tolist() == want[2]
    assert pad.tolist() == want[3]
    assert len(slots) + len(pad) == bidx.size
    # invert_blocks on CPU tensors is the plain version
    for got, w in zip(gather.invert_blocks(torch.from_numpy(bidx), nb),
                      (blocks, offsets, slots, pad)):
        assert torch.equal(got, w)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    n, qn = 2048, 13                       # Q not a multiple of 8
    db = rng.normal(size=(n, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = rng.normal(size=(qn, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db8, scales = topk.quantize_blocks(db)
    q8, _ = topk.quantize_rows(q)
    nb = n // 128
    bidx = rng.integers(0, nb, (qn, 11)).astype(np.int32)    # KB not a multiple of GROUP
    bidx[:, 4] = -1                        # padding
    bidx[:, 7] = 9                         # a block every query selects
    bidx[:, -1] = nb - 1                   # the block that straddles n_valid
    return dict(db=db, q=q, db8=db8, scales=scales, q8=q8, bidx=bidx,
                tl=rng.uniform(30, 140, n).astype(np.float32),
                qcap=rng.uniform(50, 150, qn).astype(np.float32), n_valid=n - 77)


def _operands(data, dtype):
    if dtype == "int8":
        return torch.from_numpy(data["q8"]), torch.from_numpy(data["db8"])
    q, db = torch.from_numpy(data["q"]), torch.from_numpy(data["db"])
    if dtype == "bf16":
        return q.to(torch.bfloat16), db.to(torch.bfloat16)
    return q, db


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("scale", ["none", "scale_sel", "scales"])
@pytest.mark.parametrize("use_len", [False, True])
def test_by_block_on_cpu_equals_gather_plain(data, dtype, scale, use_len):
    q, db = _operands(data, dtype)
    bidx = torch.from_numpy(data["bidx"])
    kw = {}
    if use_len:
        kw.update(tl=torch.from_numpy(data["tl"]), qcap=torch.from_numpy(data["qcap"]))
    scales = torch.from_numpy(data["scales"])
    if scale == "scale_sel":
        kw["scale_sel"] = selected_scales(scales, bidx)
    elif scale == "scales":
        kw["scales"] = scales
    names = (gather.LAUNCHES, gather.LAUNCHES_BY_BLOCK)
    n0 = [counter(n) for n in names]
    got = gather.gather_block_scores_by_block(q, db, bidx, data["n_valid"], **kw)
    want = gather.gather_plain(q, db, bidx, data["n_valid"], **kw)
    assert [counter(n) for n in names] == n0    # plain runs count nothing
    assert torch.equal(got, want)
    assert (got[:, 4 * 128:5 * 128] == NEG_CAP).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_by_block_matches_jax(data, dtype):
    """The JAX IVF's phase C in interpret mode (`gather_block_scores`, per-row
    scales for int8: `merizo_search_tpu/search/ivf.py` _probe_and_select and
    _rerank_blocks) against the port's block-major entry, length mask on."""
    q, db = _operands(data, dtype)
    scales = data["scales"] if dtype == "int8" else None
    nb = db.shape[0] // 128
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16) if dtype == "bf16" \
        else jnp.asarray(q.numpy())
    jdb = jnp.asarray(db.float().numpy()).astype(jnp.bfloat16) if dtype == "bf16" \
        else jnp.asarray(db.numpy())
    want = np.asarray(jps.gather_block_scores(
        jq, jdb, jnp.asarray(data["tl"].reshape(nb, 128)), jnp.asarray(data["qcap"]),
        jnp.asarray(data["bidx"]), data["n_valid"], use_len=True, interpret=True,
        scales=None if scales is None else jnp.asarray(scales)))
    got = gather.gather_block_scores_by_block(
        q, db, torch.from_numpy(data["bidx"]), data["n_valid"], torch.from_numpy(data["tl"]),
        torch.from_numpy(data["qcap"]),
        scales=None if scales is None else torch.from_numpy(scales)).numpy()
    masked = want <= NEG_CAP
    np.testing.assert_array_equal(got <= NEG_CAP, masked)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got[~masked], want[~masked], rtol=0, atol=1e-5)


def test_ivf_int8_scale_modes_agree(data):
    """The IVF's int8 probe passes its block-uniform scales per row: the
    scores equal the per-selected-block mode's bit for bit."""
    q, db = _operands(data, "int8")
    bidx = torch.from_numpy(data["bidx"])
    scales = torch.from_numpy(data["scales"])
    args = (q, db, bidx, data["n_valid"], torch.from_numpy(data["tl"]),
            torch.from_numpy(data["qcap"]))
    per_row = gather.gather_block_scores_by_block(*args, scales=scales)
    per_sel = gather.gather_block_scores(*args, scale_sel=selected_scales(scales, bidx))
    assert torch.equal(per_row, per_sel)


def test_by_block_writes_into_out(data):
    q, db = _operands(data, "bf16")
    bidx = torch.from_numpy(data["bidx"])
    out = torch.full((bidx.shape[0], bidx.shape[1] * 128), float("nan"))
    got = gather.gather_block_scores_by_block(q, db, bidx, data["n_valid"], out=out)
    assert got is out and not torch.isnan(out).any()
    assert torch.equal(out, gather.gather_plain(q, db, bidx, data["n_valid"]))
    for bad in (torch.empty(bidx.shape[0], 128), out.double()):
        with pytest.raises(ValueError):
            gather.gather_block_scores_by_block(q, db, bidx, data["n_valid"], out=bad)
