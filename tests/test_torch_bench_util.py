"""The port's measurement helpers (tools/_bench_util.py) on the CPU path."""

import time

import torch

from merizo_search_tpu_torch.tools import _bench_util as bu

CPU = torch.device("cpu")


def test_time_ms_on_cpu_times_each_call_after_two_warmups():
    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.003)

    ms = bu.time_ms(fn, CPU, iters=4)
    assert len(calls) == 2 + 4
    assert 3.0 <= ms < 1000.0
    assert bu.flush_buffer(CPU) is None


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bu.bound(3.35e9, 0, "int8") == (1.0, "bytes")
    ms, by = bu.bound(0, 989e9, "bf16")
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    assert bu.bound(3.35e9, 2 * 1979e9, "int8")[1] == "operations"
