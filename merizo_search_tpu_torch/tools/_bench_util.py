"""Shared pieces of the port's measurement tools and chip_smoke.py.

Device times come from CUDA events around the call, with the 50 MB L2 cache
flushed before each timed call (flush_buffer), as chip_smoke.py times its
kernels. On the CPU (`--device cpu`, for tests
of the tools themselves) the host clock stands in; such a time is a CPU
time and is printed as one, never as a device metric.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..device import resolve_device

HBM_BPS = 3.35e12                                  # H100 SXM device memory (bytes/s)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}       # dense tensor-core peaks (op/s)


def bound(nbytes, ops, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take for
    nbytes of traffic and ops operations of `dtype`, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, dev, iters=10, flush=None):
    """Mean time of fn() in ms, after two warm-up calls. CUDA: events
    around each call; `flush` (a buffer larger than the 50 MB L2) is
    rewritten before each call, outside the timed window, so the call finds
    the L2 cold. CPU: the host clock around each call."""
    for _ in range(2):
        fn()
    if dev.type == "cpu":
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return sum(ts) / iters * 1e3
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def flush_buffer(dev):
    """The buffer time_ms rewrites before each timed call: 96 MiB, more
    than the 50 MB L2 (None on the CPU)."""
    return None if dev.type == "cpu" else torch.empty(96 << 20, dtype=torch.uint8, device=dev)


def loop_ms(fn, dev, iters):
    """Mean ms per call of fn(i) over i = 0..iters-1 back to back (the
    steady state of a batch loop): one CUDA event pair around the loop, or
    the host clock on the CPU. fn(0) runs once first as a warm-up. No flush:
    each call of a scan reads a DB far larger than the L2."""
    fn(0)
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for i in range(iters):
        fn(i)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def device_line(dev) -> str:
    """What the numbers were taken on: nvidia-smi's name and power limit
    for the card, or a note that these are CPU times."""
    if dev.type == "cpu":
        return "cpu (host-clock times of the plain versions; not device metrics)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30, check=True).stdout.strip()


def make_db(n, dtype, gen, dev):
    """The JAX tools' synthetic DB: bf16 standard normal rows, or int8
    clip(40 x normal) with block scales 1/40. Returns (db, scales or None)."""
    x = torch.randn((n, 128), generator=gen, device=dev, dtype=torch.bfloat16)
    if dtype == "bf16":
        return x, None
    x8 = x.mul_(40).clamp_(-127, 127).to(torch.int8)   # in bf16, as the JAX tools
    return x8, torch.full((n,), 1 / 40.0, dtype=torch.float32, device=dev)


def db_for(dbs, n, dtype, gen, dev):
    """(db, scales) of `dtype` and n rows: the prebuilt one in `dbs` (a dict
    dtype -> (db, scales), as chip_smoke.py shares one DB a dtype among the
    tools) if it has n rows, else a new make_db."""
    if dbs and dtype in dbs and dbs[dtype][0].shape[0] == n:
        return dbs[dtype]
    return make_db(n, dtype, gen, dev)


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--seed", type=int, default=0)
    return p


def ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def setup(args):
    """(device, generator) for a tool's parsed arguments; prints the device
    line first, so every number below it stands beside the card's name and
    power limit."""
    dev = resolve_device(args.device)
    print(f"# {device_line(dev)}", flush=True)
    return dev, torch.Generator(device=dev).manual_seed(args.seed)
