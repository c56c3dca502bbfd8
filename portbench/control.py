"""Readings that set a cell's limits: the program's numbers over many seeds
(the lower readings) and each lower-precision control's (the upper ones).

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 3

Each seed is one short run of the cell at its own size and load, in one
process: set-up, `seconds` of calls, then the driver's sample compared
with the reference, as a benchmark run compares it. For a control seed,
each of the driver's `CONTROLS` then answers the same sampled queries in
the program's place and is compared the same way. One JSON line a seed,
then the largest program reading and the smallest control reading of each
number. Needs the card, as run.py does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, seconds: float, device, controls: bool, t_start: float) -> dict:
    """One seed's readings: {"program": numbers, "<control>": numbers, ...}."""
    from portbench import core
    run, kept = core.run_cell(cell, seed, seconds, False, device, t_start)
    drv = run.driver
    picks = drv.sample(kept, seed)
    answers = drv.answers(picks)
    drv.release()
    refr = drv.reference(picks)
    out = {"seed": seed, "calls": len(run.calls), "failed": run.failed,
           "hits": int((answers[1] >= 0).sum()), "ref_hits": int((refr["ids"] >= 0).sum()),
           "program": drv.compare(refr, answers)}
    if controls:
        for name in drv.CONTROLS:
            out[name] = drv.compare(refr, drv.control(picks, name))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import core
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = core.resolve(ROOT, core.load_spec(ROOT), args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    t = T_START
    for s in (int(x) for x in args.seeds.split(",")):
        rows.append(readings(cell, s, args.seconds, device, s in ctl, t))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
    summary = {"lower": {}, "upper": {}}
    for r in rows:
        for n, v in r["program"].items():
            summary["lower"][n] = max(summary["lower"].get(n, 0.0), v)
        for c in (k for k in r if k not in ("seed", "calls", "failed", "hits", "ref_hits",
                                            "program")):
            for n, v in r[c].items():
                key = f"{c}.{n}"
                summary["upper"][key] = min(summary["upper"].get(key, float("inf")), v)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
