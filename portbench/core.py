"""The benchmark's harness: one cell, one run.

Everything that belongs to one configuration, traffic mix or metric is found
by name, so a cell is added with files and `BENCHMARK.json` entries alone:

- `BENCHMARK.json` at the checkout's root names the cell, its configuration
  and its metrics;
- `configs/<config>.json` (the entry's `file`) holds the configuration's
  sizes; `workloads/<cell>.json` the traffic's parameters, its `driver`,
  its check's sample and the limits of the numbers compared;
- `drivers/<driver>.py` builds the system under test from the seed and
  makes one closed-loop call (class `Driver`);
- `metrics/<metric>.py` reads one metric from the run (`read(run)`, None
  where it finds nothing to read).

A run: set-up (the driver's construction and warm-up), then calls back to
back until `seconds` have passed, the last call finishing; with
`trace` a profiler records a steady sub-window in the middle of it. Once
the window has closed: the device's peak memory, the modules loaded, then
the driver's comparison with its plain reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "merizo_search_tpu")
TRACE_SHARE = 0.3      # the profiled sub-window's share of the window
TRACE_START = 0.3      # where in the window it starts


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _file(root: str, *parts: str) -> str:
    path = os.path.join(root, "portbench", *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(f"the benchmark has no {os.path.relpath(path, root)}")
    return path


@dataclass
class Cell:
    """One cell of BENCHMARK.json with everything found by its names."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    driver_path: str
    metrics: dict          # name -> (metric entry, reader path), in spec order
    end_to_end: list       # names of the end-to-end metrics this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: str, spec: dict, cell_name: str) -> Cell:
    """The cell `cell_name` with its configuration, traffic, driver and
    metric readers, each found by the names BENCHMARK.json gives."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    entry = cells[cell_name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(_file(root, "workloads", cell_name + ".json"))
    driver_path = _file(root, "drivers", traffic["driver"] + ".py")
    metrics, e2e, layer = {}, [], []
    for kind, out in (("end_to_end", e2e), ("per_layer", layer)):
        for m in spec[kind]:
            if _reports(m, cell_name):
                metrics[m["name"]] = (m, _file(root, "metrics", m["name"] + ".py"))
                out.append(m["name"])
    return Cell(cell_name, entry, config, traffic, driver_path, metrics, e2e, layer)


def discover(root: str) -> dict:
    """Every cell of BENCHMARK.json resolved to its files: {cell: {"config",
    "traffic", "driver", "metrics"}} (paths relative to the root). Raises
    where a name has no file."""
    spec = load_spec(root)
    out = {}
    for c in spec["workloads"]:
        cell = resolve(root, spec, c["name"])
        cfg_file = {x["name"]: x["file"] for x in spec["configs"]}[c["config"]]
        out[c["name"]] = {
            "config": cfg_file,
            "traffic": os.path.relpath(_file(root, "workloads", c["name"] + ".json"), root),
            "driver": os.path.relpath(cell.driver_path, root),
            "metrics": {n: os.path.relpath(p, root) for n, (_, p) in cell.metrics.items()},
        }
    return out


# -- host spans ----------------------------------------------------------------


class Spans:
    """The benchmark's own host spans around each layer call. While a
    profiler runs they are also profiler ranges ("portbench.<name>"), so the
    device's idle gaps can be named by what the host was doing."""

    def __init__(self):
        self.profiling = False
        self.seconds: dict = {}      # span name -> host seconds of each of its spans

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            if not self.profiling:
                yield
            else:
                import torch
                with torch.profiler.record_function("portbench." + name):
                    yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


@contextlib.contextmanager
def _no_span(name: str):
    yield


nospan = _no_span   # a driver's span outside a run (its warm-up call)


# -- the run ---------------------------------------------------------------------


@dataclass
class Run:
    """What a metric reader gets: the cell, its driver, the window's calls
    (start, end, queries answered) in host seconds, the program's phase
    timings over the window, set-up seconds and, in a traced run, the
    profiled sub-window's summary (trace.py)."""
    cell: Cell
    driver: object
    calls: list = field(default_factory=list)
    failed: int = 0
    setup_s: float = 0.0
    setup_driver_s: float = 0.0    # of which the driver's inputs, system and warm-up
    phases: dict = field(default_factory=dict)
    trace: object = None
    traced: tuple = (0, 0)         # the profiled calls: indices [first, last + 1)
    spans: object = None

    @property
    def window_s(self) -> float:
        return self.calls[-1][1] - self.calls[0][0] if self.calls else 0.0

    @property
    def answered(self) -> int:
        return sum(n for _, _, n in self.calls)

    def untraced_call_s(self) -> float | None:
        """Seconds a call outside the profiled sub-window, whose profiler
        slows the host: the window's stretches before and after it (each
        from a call's start to a call's end, so the profiler's own start
        and stop fall outside) over the calls in them."""
        a, b = self.traced
        c = self.calls
        secs, n = 0.0, 0
        if a > 0:
            secs, n = secs + c[a - 1][1] - c[0][0], n + a
        if b < len(c):
            secs, n = secs + c[-1][1] - c[b][0], n + len(c) - b
        return secs / n if n else None


class Reservoir:
    """A uniform sample of `size` of the window's calls, drawn from the seed
    (reservoir sampling): which calls the check compares."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 7])
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.items[j] = item


def _phases_delta(before: dict, after: dict) -> dict:
    return {k: (v[0] - before.get(k, (0.0, 0))[0], v[1] - before.get(k, (0.0, 0))[1])
            for k, v in after.items() if v[1] > before.get(k, (0.0, 0))[1]}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=sys.stderr) -> tuple[Run, list]:
    """Set up the cell's driver, run its window and return (run, kept calls)."""
    drv_mod = load_module(cell.driver_path, "portbench_driver_" + cell.traffic["driver"])
    t_driver = time.perf_counter()
    driver = drv_mod.Driver(cell.config, cell.traffic, seed, device)
    from merizo_search_tpu_torch.utils import profiling
    spans = Spans()
    run = Run(cell, driver, spans=spans)
    keep = Reservoir(int(cell.traffic["check"]["calls"]), seed)
    if trace:
        # the profiler's first session initialises CUPTI: in set-up, not in the window
        warm = _start_profiler(device)
        driver.call(-1, spans)
        _stop_profiler(warm)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans.seconds.clear()
    prof = None
    before = profiling.timings()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    run.setup_driver_s = t0 - t_driver
    trace_from, trace_to = t0 + TRACE_START * seconds, t0 + (TRACE_START + TRACE_SHARE) * seconds
    i = 0
    while True:
        if trace and prof is None and run.trace is None and time.perf_counter() >= trace_from:
            prof = _start_profiler(device)
            spans.profiling = True
            first = i
        c0 = time.perf_counter()
        try:
            with spans("call"):
                answer = driver.call(i, spans)
        except Exception as e:             # a failed call counts against the run
            print(f"call {i} failed: {type(e).__name__}: {e}", file=log)
            run.failed += driver.queries_per_call
            answer = None
        c1 = time.perf_counter()
        if answer is not None:
            run.calls.append((c0, c1, driver.queries_per_call))
            keep.offer((i, answer))
        else:
            run.calls.append((c0, c1, 0))
        i += 1
        if prof is not None and (c1 >= trace_to or c1 - t0 >= seconds):
            spans.profiling = False
            run.trace = _stop_profiler(prof)
            run.traced = (first, i)
            prof = None
        if c1 - t0 >= seconds:
            break
    run.phases = _phases_delta(before, profiling.timings())
    return run, keep.items


def _start_profiler(device):
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = profile(activities=acts)
    prof.__enter__()
    return (prof, torch.profiler.record_function("portbench.window").__enter__())


def _stop_profiler(handle):
    prof, window = handle
    window.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return prof


def read_metrics(run: Run, names: list) -> dict:
    """Each named metric by its reader; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for name in names:
        entry, path = run.cell.metrics[name]
        value = load_module(path, "portbench_metric_" + name.replace(".", "_")).read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {name} read {value}")
        out[name] = {"value": float(value), "unit": entry["unit"]}
    return out


def device_info(device, chips: int) -> dict:
    """The result line's `device`: the card's name, the cards used, and the
    peak of device memory allocated since the end of set-up."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


BIG = 1.7976931348623157e308    # an infinite gap, written as the largest float


def check(run: Run, kept: list, seed: int) -> dict:
    """The comparison with the plain reference, once the window has closed:
    the driver's sample of the kept calls, the program's answers to it, the
    program's state freed, the reference worked out, and each number
    compared beside its limit (the workload's `limits`)."""
    drv = run.driver
    if not kept:
        return {}
    picks = drv.sample(kept, seed)
    answers = drv.answers(picks)
    drv.release()
    numbers = drv.compare(drv.reference(picks), answers)
    limits = run.cell.traffic["limits"]
    return {n: {"value": min(float(v), BIG), "limit": float(limits[n])}
            for n, v in numbers.items()}


def correct(run: Run, compared: dict) -> bool:
    """No call failed, some answered, and every number within its limit."""
    if run.failed or not run.answered or not compared:
        return False
    return all(c["value"] <= c["limit"] for c in compared.values())
