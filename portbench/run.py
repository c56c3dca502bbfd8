"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and the
port (`merizo_search_tpu_torch`). The cell's inputs and weights are made
from the seed; its calls run back to back for `seconds`; the result is
checked against the plain reference. With --trace 0 the line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
from a profiled sub-window. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers compared,
each beside its limit. Exits non-zero without a result where the card is
missing, the cell asks for more cards than there are, or JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window_line(run) -> str:
    """The window's calls at a glance: their count, the 5th, 50th and 95th
    percentiles of a call's ms, and the queries a second in each quarter."""
    import numpy as np
    ms = np.array([(b - a) * 1e3 for a, b, _ in run.calls])
    t0, span = run.calls[0][0], run.window_s
    quarters = [sum(n for a, b, n in run.calls if q * span / 4 <= b - t0 < (q + 1) * span / 4)
                / (span / 4) for q in range(4)]
    return (f"set-up {run.setup_s:.3f} s ({run.setup_driver_s:.3f} s of it the driver's), "
            f"window {span:.3f} s, {len(ms)} calls, ms p5/p50/p95 "
            f"{np.percentile(ms, 5):.3f}/{np.percentile(ms, 50):.3f}/{np.percentile(ms, 95):.3f}, "
            "queries/s by quarter " + " ".join(f"{x:.0f}" for x in quarters)
            + ", host ms a span p50 " + " ".join(
                f"{k} {np.median(v) * 1e3:.3f}" for k, v in run.spans.seconds.items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import core, trace as trace_mod

    cell = core.resolve(ROOT, core.load_spec(ROOT), args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run, kept = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    torch.cuda.synchronize(device)
    dev = core.device_info(device, chips)
    bad = core.forbidden_modules()
    if bad:
        print("loaded modules of JAX or the JAX package: " + ", ".join(bad), file=sys.stderr)
        return 3
    if args.trace:
        run.trace = trace_mod.summarize(run.trace) if run.trace is not None else None
        if run.trace is not None:
            dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
    metrics = core.read_metrics(run, cell.per_layer if args.trace else cell.end_to_end)
    compared = core.check(run, kept, args.seed)
    result = {"correct": core.correct(run, compared),
              "attempted": run.answered + run.failed, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["compared"] = compared
    print(window_line(run), file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
