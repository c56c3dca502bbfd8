"""A whole small run of each cell on the CPU, with the timed path sound and
then broken underneath: `correct` holds for the sound run and comes out
false for each fault the cell can have (an answer altered where it is
produced, half the batch left out, a step that returns its state
unchanged). A cell on one card has no exchange between chips to leave
out. And each lower-precision control, in the program's place, fails one
of the cell's numbers."""

import numpy as np
import pytest
import torch

from pb_small import CATH, TED, cpu_run, small_cell

from portbench import core

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", [TED, CATH])
def test_a_sound_run_is_correct(cell):
    run, compared, ok = cpu_run(cell, SEED)
    assert ok, compared
    assert run.failed == 0 and len(run.calls) >= 2
    assert set(compared) == set(small_cell(cell).traffic["limits"])


def _ted_fault(kind):
    from merizo_search_tpu_torch.search import engine
    orig = engine.shard_topk
    last = {}

    def broken(rep, shard, me, n_valid, k, mincov, use_len):
        if kind == "half":
            qd, qs, qlen = rep
            h = qd.shape[0] // 2
            v, i = orig((qd[:h], qs[:h], qlen[:h]), shard, me, n_valid, k, mincov, use_len)
            return torch.cat([v, v]), torch.cat([i, i])
        v, i = orig(rep, shard, me, n_valid, k, mincov, use_len)
        if kind == "altered":
            i = i.clone()
            i[:, 0] += 1
        if kind == "stale":
            prev = last.get("out")
            last["out"] = (v, i)
            if prev is not None:
                return prev
        return v, i
    return engine, "shard_topk", broken


def _cath_fault(kind):
    from merizo_search_tpu_torch.pipeline import dbsearch
    from merizo_search_tpu_torch.search import engine
    if kind == "altered":
        orig = engine.SearchEngine.search

        def search(self, q, k, query_lens=None, mincov=0.0):
            v, i = orig(self, q, k, query_lens, mincov)
            i = i.copy()
            i[:, 0] = (i[:, 0] + 1) % self.db.size
            return v, i
        return engine.SearchEngine, "search", search
    orig_embed = dbsearch.embed_structures
    last = {}

    def embed(model, coords, *a, **kw):
        if kind == "half":
            h = len(coords) // 2
            e = orig_embed(model, coords[:h], *a, **kw)
            return np.concatenate([e, np.repeat(e.mean(0, keepdims=True), len(coords) - h, 0)])
        e = orig_embed(model, coords, *a, **kw)
        prev = last.get("out")
        last["out"] = e
        return e if prev is None else prev
    return dbsearch, "embed_structures", embed


@pytest.mark.parametrize("kind", ["altered", "half", "stale"])
@pytest.mark.parametrize("cell", [TED, CATH])
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    target, name, broken = (_ted_fault if cell == TED else _cath_fault)(kind)
    monkeypatch.setattr(target, name, broken)
    _, compared, ok = cpu_run(cell, SEED)
    assert not ok, compared


@pytest.mark.parametrize("cell", [TED, CATH])
def test_each_control_fails_a_number(cell):
    c = small_cell(cell)
    run, kept = core.run_cell(c, SEED, 0.5, False, torch.device("cpu"), 0.0)
    drv = run.driver
    picks = drv.sample(kept, SEED)
    drv.release()
    refr = drv.reference(picks)
    limits = c.traffic["limits"]
    for name in drv.CONTROLS:
        numbers = drv.compare(refr, drv.control(picks, name))
        assert any(v > limits[n] for n, v in numbers.items()), (name, numbers)
