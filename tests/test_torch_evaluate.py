"""The port's segmentation evaluation (segment/evaluate.py) against the JAX
package's module, on the inputs of tests/test_evaluate.py: the ground-truth
and predicted chopping grammars, the per-chain scores and the aggregate
over a CSV row and a `_segment.tsv`. Both are host code: every result must
be equal."""

import os

import pytest

from merizo_search_tpu.segment import evaluate as jev
from merizo_search_tpu_torch.segment import evaluate as tev

GT = ["100-129_168-292:40_1078|1-99_130-167:40_1078", "1-50:1_2|51-99:999_999",
      "1-100:1_1|101-200:2_2", "", "5-5:1_1"]
PRED = ["1001-1023_1039-1073,1024-1038", "na", "", "1-100,101-200", "1-95,96-200",
        "1-200", "7"]
PAIRS = [("1-100,101-200", GT[2], 8), ("1-95,96-200", GT[2], 8),
         ("1-95,96-200", GT[2], 2), ("1-200", GT[2], 8), ("na", GT[2], 8),
         ("", "", 8), ("100-129_168-292,1-99_130-167", GT[0], 8)]


@pytest.mark.parametrize("col7", GT)
def test_parse_gt_chopping_matches_jax(col7):
    assert tev.parse_gt_chopping(col7) == jev.parse_gt_chopping(col7)


@pytest.mark.parametrize("dom_str", PRED)
def test_parse_pred_chopping_matches_jax(dom_str):
    assert tev.parse_pred_chopping(dom_str) == jev.parse_pred_chopping(dom_str)


@pytest.mark.parametrize("pred,true,tol", PAIRS)
def test_score_chopping_matches_jax(pred, true, tol):
    p, t = tev.parse_pred_chopping(pred), tev.parse_gt_chopping(true)
    assert tev.score_chopping(p, t, tol=tol) == jev.score_chopping(p, t, tol=tol)


def test_evaluate_csv_and_tsv_match_jax(tmp_path):
    gt_path = os.path.join(tmp_path, "gt.csv")
    with open(gt_path, "w") as fh:
        fh.write("19hc,19hcA,A,2,1,292,100-129_168-292:40_1078|1-99_130-167:40_1078\n"
                 "1abc,1abcA,A,2,1,200,1-100:1_1|101-200:2_2\n")
    tsv = os.path.join(tmp_path, "pred_segment.tsv")
    with open(tsv, "w") as fh:
        fh.write("name\tlength\tnres_dom\tnres_ndr\tnum_dom\tconf\ttime\tchopping\n"
                 "19hcA\t292\t292\t0\t2\t0.9\t0.1\t100-129_168-292,1-99_130-167\n"
                 "1abcA.pdb\t200\t200\t0\t1\t0.8\t0.1\t1-95,96-200\n"
                 "zzzzA\t50\t50\t0\t1\t0.8\t0.1\t1-50\n")
    gt = tev.load_gt_csv(gt_path)
    assert gt == jev.load_gt_csv(gt_path)
    preds = tev.load_segment_tsv(tsv)
    assert preds == jev.load_segment_tsv(tsv)
    got, want = tev.evaluate(gt, preds), jev.evaluate(gt, preds)
    assert got == want and got["n"] == 2
