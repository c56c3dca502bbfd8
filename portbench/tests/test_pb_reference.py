"""The benchmark's plain references against the port's plain paths, and its
traffic generators, on the CPU at small sizes."""

import numpy as np
import pytest
import torch

import pb_small
from pb_small import CATH, TED, small_cell

from portbench.drivers import dbsearch as cath_driver
from portbench.drivers import shard_scan
from portbench.reference import foldclass as ref_fc
from portbench.reference import topk as ref
from portbench.synthetic import helical_backbone

CPU = torch.device("cpu")


def test_frozen_foldclass_equals_the_ports_network():
    """The published concat form, one structure at its own length, against
    FoldClassNet under the same seeded weights, batched and masked by the
    port's bucketing (embed_structures)."""
    from merizo_search_tpu_torch.models.foldclass import FoldClassNet
    from merizo_search_tpu_torch.pipeline.embed import embed_structures
    w = ref_fc.seeded_weights(123, CPU)
    net = FoldClassNet()
    assert net.load_state_dict(w, strict=False).missing_keys == ["posenc_as.pe"]
    rng = np.random.default_rng(0)
    coords = [helical_backbone(rng, n)[:, 1].astype(np.float32) for n in (37, 64, 100, 131)]
    port = embed_structures(net.eval(), coords)
    for c, p in zip(coords, port):
        r = ref_fc.embed(w, torch.from_numpy(c)[None])[0].numpy()
        assert np.abs(r - p).max() <= 1e-5 * np.abs(r).max()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10, 3.0e-30])
    got = ref_fc.round_tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2 ** -11, -1.0 - 2 ** -10]
    bits = got.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 9])
def test_int8_reference_equals_the_ports_shard_scan(seed):
    """The exact int8 top-k with block scales against the engine's search
    of a ragged shard's int8 rows (phases A-B-C in their plain versions)."""
    from merizo_search_tpu_torch.ops import topk as topk_ops
    from merizo_search_tpu_torch.search.engine import SearchEngine
    valid = shard_scan.shard_rows({"db_rows": 40900, "mesh_devices": 8, "shard_index": 7})
    assert valid == 5060
    gen = torch.Generator().manual_seed(seed)
    rows8, scales = shard_scan.make_shard(5120, valid, gen, CPU)
    q = shard_scan.make_queries(rows8, scales, valid, 24, 0.75, [0.5, 0.98], gen, CPU)
    db = shard_scan.int8_db(rows8[:valid].numpy(), scales[:valid].numpy())
    v, i = SearchEngine(db, "int8", CPU).search(q, 50)
    q8, s8 = ref.quantize_rows(ref.normalize_rows(q))
    qd, qs = topk_ops.query_operands(ref.normalize_rows(q), torch.int8, CPU)
    assert np.array_equal(q8, qd.numpy()) and np.array_equal(s8, qs.numpy())
    rv, ri = ref.int8_topk(q8, s8, rows8, scales, valid, 50, chunk=1000)
    assert np.abs(v - rv).max() <= 1e-6
    exact = ref.int8_scores_of(q8, s8, rows8, scales, valid, i)
    assert np.abs(v - exact).max() <= 1e-6
    assert ri.min() >= 0 and ri.max() < valid


def test_bf16_reference_equals_the_ports_engine_with_the_length_channel():
    from merizo_search_tpu_torch.db.codecs import FlatDB
    from merizo_search_tpu_torch.search.engine import SearchEngine
    rng = np.random.default_rng(4)
    n = 3000
    rows = rng.normal(size=(n, 128)).astype(np.float32)
    q = rng.normal(size=(20, 128)).astype(np.float32)
    rows[:20] = q + 0.3 * rng.normal(size=(20, 128))
    tlen = rng.integers(30, 200, n)
    qlen = rng.integers(40, 150, 20)
    db = FlatDB.from_arrays(rows, [(f"d{i}", None, "A" * int(t)) for i, t in enumerate(tlen)])
    v, i = SearchEngine(db, "bf16", "cpu").search(q, 10, query_lens=qlen, mincov=0.7)
    rb = torch.from_numpy(ref.normalize_rows(rows)).to(torch.bfloat16)
    tl = torch.from_numpy(tlen.astype(np.float32))
    qn = ref.normalize_rows(q)
    rv, ri = ref.bf16_topk(qn, rb, tl, qlen, 0.7, 10, chunk=700)
    assert np.abs(np.where(np.isinf(rv), 0, v - rv)).max() <= 1e-6
    assert np.array_equal(np.isinf(v), np.isinf(rv))
    exact = ref.bf16_scores_of(qn, rb, tl, qlen, 0.7, i)
    ok = i >= 0
    assert np.abs(v[ok] - exact[ok]).max() <= 1e-6


def test_shard_and_queries_repeat_for_a_seed():
    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        rows8, scales = shard_scan.make_shard(1280, 1000, gen, CPU)
        return rows8, scales, shard_scan.make_queries(rows8, scales, 1000, 32, 0.9,
                                                      [0.5, 0.98], gen, CPU)
    a, b, c = make(2 ** 33 + 1), make(2 ** 33 + 1), make(5)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2])) and np.array_equal(a[2], b[2])
    assert not torch.equal(a[0], c[0]) and not np.array_equal(a[2], c[2])
    # padding rows are zero; those of the straddling block share its scale,
    # a block of padding alone has the scale 1
    assert int(a[0][1000:].abs().sum()) == 0
    assert torch.all(a[1][896:1024] == a[1][896]) and float(a[1][896]) != 1.0
    assert torch.all(a[1][1024:] == 1.0)


def test_cath_call_lengths_are_the_same_for_every_seed_and_inputs_repeat():
    cell = small_cell(CATH)
    lengths = cath_driver.slot_lengths(cell.config, 256)
    full = cath_driver.slot_lengths({"length_median": 150, "length_sigma": 0.5,
                                     "length_clip": [40, 600]}, 256)
    assert len(lengths) == 256 and full[0] == 40 and full[-1] == 600
    a = cath_driver.Driver(cell.config, cell.traffic, 7, CPU)
    b = cath_driver.Driver(cell.config, cell.traffic, 7, CPU)
    c = cath_driver.Driver(cell.config, cell.traffic, 8, CPU)
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.tlen, b.tlen)
    for x, y in zip(a.inputs(3), b.inputs(3)):
        assert np.array_equal(x["coords"], y["coords"]) and x["seq"] == y["seq"]
    assert [len(x["seq"]) for x in a.inputs(3)] == [len(x["seq"]) for x in c.inputs(1)]
    assert not np.array_equal(a.inputs(3)[0]["coords"], c.inputs(3)[0]["coords"])


def test_the_small_cuts_keep_the_widths():
    assert pb_small.small_cell(TED).config["dim"] == 128
    assert pb_small.small_cell(CATH).config["foldclass"]["m_dim"] == 256


def test_bf16_ambiguity_marks_components_at_a_rounding_midpoint():
    """A float32 value within the tolerance of the midpoint between two bf16
    values may round either way; the slack is their distance times the row's
    component, and nothing elsewhere."""
    mid = 1 + 2 ** -8
    q = np.array([[mid + 1e-7, mid - 1e-7, -mid + 1e-7, 0.3, 1.0, 0.0]], np.float32)
    amb = ref.bf16_ambiguity(q, 1e-5)
    assert amb.tolist() == [[2 ** -7, 2 ** -7, 2 ** -7, 0.0, 0.0, 0.0]]
    assert ref.bf16_ambiguity(q, 1e-9).tolist() == [[0.0] * 6]
    rows = torch.tensor([[0.5, 0.25, 0.0, 1.0, 1.0, 1.0], [2.0] * 6], dtype=torch.bfloat16)
    assert ref.bf16_slack(amb, rows, np.array([[0, 1, -1]])).tolist() == [
        [0.75 * 2 ** -7, 6 * 2 ** -7, 0.0]]
