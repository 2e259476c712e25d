"""The profiler's trace of a stretch of the program, reduced to what the
per-layer metrics read: the device activities (kernels, copies, sets)
by name, their union's seconds (busy), the stretch's host seconds
(window), and the device's idle gaps by the host operation that
launched the activity ending each gap.

The union of the device intervals is the reduction chip_smoke.py's
trace_units makes. The trace is written to a temporary directory (under
TMPDIR), read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn, device: torch.device) -> dict:
    """Run fn() under torch.profiler (host operations and, on a card, the
    device), synchronised at both ends, and summarise its trace."""
    from torch.profiler import ProfilerActivity, profile as _profile
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return summarize(events, window_s)


def summarize(events: list, window_s: float) -> dict:
    """busy_s, window_s, the device activities' count, their seconds by
    name and count by name, and the idle gaps' seconds by the host
    operation that launched the activity after each gap."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and "dur" in e), key=lambda e: e["ts"])
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = e["name"]
    busy_us, end = 0.0, None
    gaps, seconds, counts = {}, {}, {}
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if end is not None and a > end:
            who = ops.get(e.get("args", {}).get("External id"), e["name"])
            gaps[who] = gaps.get(who, 0.0) + (a - end) / 1e6
        if end is None or b > end:
            busy_us += b - max(a, end if end is not None else a)
            end = b
        seconds[e["name"]] = seconds.get(e["name"], 0.0) + e["dur"] / 1e6
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return dict(busy_s=busy_us / 1e6, window_s=window_s, activities=len(dev),
                seconds=seconds, counts=counts, gaps=gaps)


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of a {name: seconds} dict as [[name, s]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def kernel_time(summary: dict, name: str) -> tuple:
    """(launches, mean seconds a launch) of the device kernels whose
    name holds `name`; (0, None) when there is none."""
    keys = [k for k in summary["counts"] if name in k]
    n = sum(summary["counts"][k] for k in keys)
    if not n:
        return 0, None
    return n, sum(summary["seconds"][k] for k in keys) / n

