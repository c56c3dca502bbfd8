"""Small cells for the benchmark's CPU tests: each cell of BENCHMARK.json,
and the held CATH cell, with its configuration and traffic cut to a size
the CPU runs in seconds (widths kept: 128-d rows, Foldclass at its
published widths)."""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import core  # noqa: E402

torch.set_num_threads(2)

TED = "ted365m_int8_mesh8.q256"
CATH = "cath43_bf16.search"
CUTS = {
    # 40 blocks a card, the last shard ragged (5,060 valid rows of 5,120)
    TED: ({"db_rows": 40900, "rows_held": 5120},
          {"batch": 16, "pool_batches": 4, "check": {"calls": 3, "per_call": 4}}),
    CATH: ({"db_rows": 3000, "length_clip": [20, 60], "length_median": 35},
           {"batch": 8, "copies": 4, "check": {"calls": 2, "per_call": 4}}),
}


# The CATH 4.3 cell is held out of BENCHMARK.json until its query lengths
# have a published source; its driver and reference stay tested here.
HELD = {"configs": [{"name": "cath43_bf16", "file": "portbench/configs/cath43_bf16.json"}],
        "workloads": [{"name": CATH, "config": "cath43_bf16", "traffic": "search", "chips": 1}]}


def spec(root: str = ROOT) -> dict:
    """BENCHMARK.json with the held cell's entries added."""
    out = core.load_spec(root)
    for key, entries in HELD.items():
        names = {e["name"] for e in out[key]}
        out[key] = out[key] + [e for e in entries if e["name"] not in names]
    return out


def small_cell(name: str, root: str = ROOT) -> core.Cell:
    cell = core.resolve(root, spec(root), name)
    cfg, traffic = CUTS[name]
    cell.config.update(cfg)
    cell.traffic.update(traffic)
    return cell


def cpu_run(name: str, seed: int, seconds: float = 1.5, trace: bool = False):
    """(run, compared, correct) of a small run of the cell on the CPU."""
    cell = small_cell(name)
    run, kept = core.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                              time.perf_counter())
    compared = core.check(run, kept, seed)
    return run, compared, core.correct(run, compared)
