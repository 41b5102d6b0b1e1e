"""A ``torch.profiler`` capture of a stretch of units, read into the numbers
the per-layer metrics take: device busy time, the time of a kernel family
on the device's own order, launches, the top device operations and the
longest idle gaps by what the host was doing.

The capture is exported as a Chrome trace into ``TMPDIR``, read back and
deleted. A kernel family is found by kernel name and stream order alone
(``Trace.kernel_runs_s``), never by the host range around its launch: a
CUDA graph replays every kernel under one ``cudaGraphLaunch``, which lies
inside none of the ranges that launched them when the graph was captured.
The idle gaps are still put down to the host range around the launch of
the operation that ends each (matched by its correlation id).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "portbench.window"


def union_s(spans) -> float:
    """Seconds covered by the union of (start, end) spans in microseconds."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


def gaps(spans, lo: float, hi: float):
    """The idle (start, end) gaps between the union of ``spans`` inside
    [lo, hi]."""
    out, end = [], lo
    for a, b in sorted(spans):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def short(name: str) -> str:
    """A kernel's name without its namespaces' anonymous parts, argument
    list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def base(name: str) -> str:
    """A kernel's own name: no namespace, template arguments or argument
    list (``copenerf::wgrad_final_kernel(WgradArgs, float const*)`` ->
    ``wgrad_final_kernel``)."""
    return short(name).split("<")[0].rsplit("::", 1)[-1]


class Trace:
    """The events of one capture."""

    def __init__(self, events: list, wall_s: float):
        self.wall_s = wall_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (e["pid"], e["tid"], float(e["ts"]))
        self.host = collections.defaultdict(list)    # (pid, tid) -> ranges
        for e in events:
            if e.get("cat") in HOST_CATS:
                a = float(e["ts"])
                self.host[(e["pid"], e["tid"])].append(
                    (a, a + float(e["dur"]), e["name"]))
        for ranges in self.host.values():
            ranges.sort()
        win = [r for rs in self.host.values() for r in rs if r[2] == WINDOW]
        self.lo = min((a for a, _, _ in win), default=min(
            (float(e["ts"]) for e in self.device), default=0.0))
        self.hi = max((b for _, b, _ in win), default=max(
            (float(e["ts"]) + float(e["dur"]) for e in self.device),
            default=0.0))

    @staticmethod
    def _span(e):
        a = float(e["ts"])
        return a, a + float(e["dur"])

    @property
    def busy_s(self) -> float:
        return union_s([self._span(e) for e in self.device])

    @property
    def window_s(self) -> float:
        return self.wall_s

    def _innermost(self, key, ts):
        """The innermost host range of thread ``key`` around ``ts``: ranges
        nest, so it is the latest-starting one that has not ended."""
        ranges = self.host.get(key, [])
        i = bisect.bisect_right(ranges, (ts, float("inf"), ""))
        for j in range(i - 1, max(-1, i - 50000), -1):
            if ranges[j][1] >= ts:
                return ranges[j]
        return None

    def kernel_runs_s(self, leads, follow=()) -> float:
        """Device seconds of every run of a kernel family. A run is a kernel
        whose name holds one of ``leads``, with the kernels whose own name
        (``base``) starts with one of ``follow`` that come directly after
        it on its stream, by start time; it stops at the first kernel of
        any other name. The device's own order says which lead a shared
        follower (the weight-gradient reduction that K1-bwd and K3-bwd both
        launch) belongs to, however the kernels were launched."""
        follow = tuple(follow)
        total = 0.0
        for ordered in self.streams.values():
            in_run = False
            for e in ordered:
                if any(f in e["name"] for f in leads):
                    in_run = True
                elif not (in_run and base(e["name"]).startswith(follow)):
                    in_run = False
                    continue
                total += float(e["dur"])
        return total * 1e-6

    @functools.cached_property
    def streams(self) -> dict:
        """(device, stream) -> its kernels by start time."""
        by = collections.defaultdict(list)
        for e in self.kernels:
            args = e.get("args", {})
            by[(args.get("device", e["pid"]),
                args.get("stream", e["tid"]))].append(e)
        for ordered in by.values():
            ordered.sort(key=lambda e: float(e["ts"]))
        return dict(by)

    @property
    def launches(self) -> int:
        return len(self.kernels)

    def top_ops(self, k=10):
        by = collections.Counter()
        for e in self.kernels:
            by[short(e["name"])] += float(e["dur"]) * 1e-6
        return [[n, s] for n, s in by.most_common(k)]

    def top_gaps(self, k=10):
        """Idle seconds inside the window, summed by the innermost host
        range around the launch of the device operation that ends the
        gap."""
        ordered = sorted(self.device, key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in ordered]
        by = collections.Counter()
        for a, b in gaps([self._span(e) for e in ordered], self.lo, self.hi):
            i = bisect.bisect_left(starts, b)
            by[self._label(ordered[i]) if i < len(ordered)
               else "host: end of window"] += (b - a) * 1e-6
        return [[n, s] for n, s in by.most_common(k)]

    def _label(self, e) -> str:
        where = self.launch.get(e.get("args", {}).get("correlation"))
        if not where:
            return "host: unattributed"
        r = self._innermost(where[:2], where[2])
        return f"host: {r[2]}" if r else "host: outside any op"


@contextlib.contextmanager
def capture(device):
    """Profile the block (host ops and the card) and yield a holder whose
    ``trace`` is the ``Trace`` once the block has ended. The block runs
    inside the host range ``portbench.window``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = {}
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            yield holder
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("ph") == "X" and "dur" in e]
    finally:
        os.remove(path)
    holder["trace"] = Trace(events, wall)
