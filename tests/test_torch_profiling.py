"""The port's spans and counters (utils/profiling): parents and the shared
id of one call, self time, the bounded ring, profiler ranges only while a
profiler records, the spans of `SearchEngine.search` and the fused scan's
phases, and counters bumped from many threads. The `gpu` case times a
phase on the card's stream with no synchronize on the call path."""

import sys
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merizo_search_tpu_torch.db.codecs import FlatDB
from merizo_search_tpu_torch.ops import blockmax
from merizo_search_tpu_torch.ops.topk import quantize_blocks
from merizo_search_tpu_torch.search.engine import SearchEngine
from merizo_search_tpu_torch.utils import profiling

torch.set_num_threads(2)

CHILDREN = ("search.prepare", "search.scan", "search.copy_back", "search.finish")
SCAN = ("scan.phase_a", "scan.phase_b", "scan.phase_c", "scan.final", "scan.dequant")


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _int8_engine(device, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, 128)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q8, s = quantize_blocks(emb)
    db = FlatDB("mmap", prefix=None, _emb=None, _emb8=q8, _scales=s,
                _lengths=np.broadcast_to(np.int32(0), (n,)), size=n, dim=128,
                normalised=True)
    eng = SearchEngine(db, "int8", device)
    return eng, rng.standard_normal((16, 128)).astype(np.float32)


def _by_name():
    return {r.name: r for r in profiling.spans()}


def test_nesting_records_the_parent_and_one_id_and_self_time_leaves_out_children():
    with profiling.phase("top"):
        with profiling.phase("a"):
            time.sleep(0.01)
            with profiling.phase("a.inner"):
                time.sleep(0.01)
        with profiling.phase("b"):
            time.sleep(0.01)
    with profiling.phase("next"):
        pass
    r = _by_name()
    assert r["top"].parent is None and r["top"].root == r["top"].id
    assert r["a"].parent == r["b"].parent == r["top"].id
    assert r["a.inner"].parent == r["a"].id
    assert {r[n].root for n in ("top", "a", "a.inner", "b")} == {r["top"].id}
    assert r["next"].root == r["next"].id != r["top"].id
    for n in ("a", "a.inner", "b"):
        assert r["top"].start <= r[n].start <= r[n].end <= r["top"].end
    t = profiling.timings()

    def dur(n):
        return r[n].end - r[n].start
    assert t["top"].seconds == pytest.approx(dur("top"))
    assert t["top"].self_s == pytest.approx(dur("top") - dur("a") - dur("b"))
    assert t["a"].self_s == pytest.approx(dur("a") - dur("a.inner"))
    assert t["a.inner"].self_s == pytest.approx(dur("a.inner"))
    assert t["a"].calls == 1 and t["a"].device_s == 0.0


def test_a_span_that_raises_still_closes():
    with pytest.raises(ValueError):
        with profiling.phase("outer"):
            with profiling.phase("fails"):
                raise ValueError("x")
    with profiling.phase("after"):
        pass
    r = _by_name()
    assert r["fails"].parent == r["outer"].id and r["fails"].end >= r["fails"].start
    assert r["after"].parent is None           # the stack was unwound
    assert profiling.timings()["fails"].calls == 1


def test_the_ring_drops_the_oldest_and_timings_keep_their_totals(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=4))
    for i in range(10):
        with profiling.phase(f"s{i % 2}"):
            pass
    recs = profiling.spans()
    assert [r.name for r in recs] == ["s0", "s1", "s0", "s1"]
    assert recs[0].id < recs[-1].id
    t = profiling.timings()
    assert t["s0"].calls == t["s1"].calls == 5


def test_without_a_profiler_no_range_event_or_synchronize_is_entered(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")
    monkeypatch.setattr(profiling, "_HostRange", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    eng, q = _int8_engine("cpu")
    eng.search(q, 10)
    with profiling.phase("scan.phase_a", torch.device("cuda", 0)):   # a device span: nothing
        pass
    names = [r.name for r in profiling.spans()]
    assert set(names) == {"db_resident", "search", *CHILDREN}
    assert "scan.phase_a" not in profiling.timings()


def test_under_a_profiler_the_spans_are_nested_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.phase("outer"):
            with profiling.phase("inner", torch.device("cpu")):
                torch.ones(4).sum()
    assert not torch.autograd.profiler._is_profiler_enabled
    ev = {e.name: e for e in prof.events() if e.name.startswith("mst.")}
    assert set(ev) == {"mst.outer", "mst.inner"}
    o, i = ev["mst.outer"].time_range, ev["mst.inner"].time_range
    assert o.start <= i.start <= i.end <= o.end
    r = _by_name()
    assert r["inner"].parent == r["outer"].id and r["inner"].device_s is None   # host time only


def test_a_search_is_one_id_over_its_children_and_the_scans_phases():
    eng, q = _int8_engine("cpu")
    eng.search(q, 10)                             # residency outside the profiled call
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vals, idxs = eng.search(q, 10)
    assert vals.shape == idxs.shape == (16, 10)
    recs = profiling.spans()
    r = {x.name: x for x in recs}
    assert sorted(r) == sorted(["search", *CHILDREN, *SCAN]) and len(recs) == len(r)
    top = r["search"]
    assert {x.root for x in recs} == {top.id}
    assert all(r[n].parent == top.id for n in CHILDREN)
    assert all(r[n].parent == r["search.scan"].id for n in SCAN)
    ranges = {e.name for e in prof.events() if e.name.startswith("mst.")}
    assert ranges == {"mst." + n for n in r}


def test_counters_from_eight_threads_lose_no_update():
    assert profiling.declare("t.launches") == "t.launches"
    profiling.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(10_000):
                profiling.count("t.launches")
        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counter("t.launches") == 80_000
    assert profiling.counters()["t.launches"] == 80_000
    profiling.reset_counters()
    assert profiling.counter("t.launches") == 0


@pytest.mark.parametrize("use", [profiling.count, profiling.counter])
def test_a_counter_nothing_declared_raises(use):
    """A misspelt or renamed counter fails where it is bumped or read, so an
    assertion that a kernel did not launch cannot pass on a wrong name."""
    with pytest.raises(KeyError):
        use("blockmax.launchez")
    assert blockmax.LAUNCHES in profiling.counters()


@pytest.mark.gpu
def test_phase_b_reads_device_seconds_on_the_card_without_a_synchronize(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng, q = _int8_engine("cuda", n=200_000)
    eng.search(q, 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        eng.search(q, 10)                          # warm the profiler
        profiling.reset()
        with monkeypatch.context() as m:
            def refuse(*a, **k):
                raise AssertionError("a synchronize on the call path")
            m.setattr(torch.cuda, "synchronize", refuse)
            m.setattr(torch.cuda.Event, "synchronize", refuse)
            eng.search(q, 10)
    r = _by_name()
    assert {x.root for x in r.values()} == {r["search"].id}
    for n in SCAN:
        assert r[n].device_s is not None and r[n].device_s > 0, n
    assert 0 < r["scan.phase_b"].device_s < r["search"].end - r["search"].start
    assert profiling.timings()["scan.phase_b"].device_s == r["scan.phase_b"].device_s
