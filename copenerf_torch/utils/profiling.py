"""Step timing and profiler traces (port of ``copenerf_tpu/utils/profiling.py``).

``StepTimer`` is the JAX package's rolling throughput meter with the same
JSONL journal; its ``tick(sync=...)`` synchronizes the CUDA device instead of
``jax.block_until_ready``. ``trace`` is the counterpart of the JAX package's
``jax.profiler`` trace: a ``torch.profiler`` capture exported as a Chrome
trace, summarized as the window's wall time and the device's busy share.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_busy_us(trace_path: str, annotation: str | None = None):
    """(busy, annotated wall, annotated busy) in microseconds of a Chrome
    trace: ``busy`` is the union of the device's kernel, copy and memset
    intervals; the other two are the summed host spans of the
    ``record_function(annotation)`` ranges and the device busy time inside
    them (0 without an annotation)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if annotation is not None
              and e.get("cat") == "user_annotation"
              and e.get("name") == annotation]
    inside = [(max(a, lo), min(b, hi)) for lo, hi in ranges
              for a, b in spans if a < hi and b > lo]
    return (_union_us(spans), sum(hi - lo for lo, hi in ranges),
            _union_us(inside))


@contextlib.contextmanager
def trace(log_dir: str, device="cuda", annotation: str | None = None):
    """Capture a ``torch.profiler`` trace of the block into
    ``<log_dir>/trace_<ms>.json`` (Chrome trace format; Perfetto opens it).

    Yields a dict that is filled when the block ends: ``wall_ms`` (host
    clock, the device synchronized at both ends), ``device_busy_ms`` (the
    union of the device's kernel, copy and memset intervals), ``busy_share``
    (their ratio; the profiler's own per-launch cost is in the wall time)
    and ``trace`` (the file); with ``annotation``, the same two readings
    outside its ``record_function`` ranges (``*_outside``)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    summary = {}
    synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield summary
        synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    busy_us, ann_wall_us, ann_busy_us = device_busy_us(path, annotation)
    busy_ms = busy_us / 1e3
    summary.update(wall_ms=wall_ms, device_busy_ms=busy_ms,
                   busy_share=busy_ms / wall_ms if wall_ms > 0 else 0.0,
                   trace=path)
    if annotation is not None:
        out_wall = wall_ms - ann_wall_us / 1e3
        out_busy = busy_ms - ann_busy_us / 1e3
        summary.update(wall_ms_outside=out_wall,
                       device_busy_ms_outside=out_busy,
                       busy_share_outside=(out_busy / out_wall
                                           if out_wall > 0 else 0.0))


class StepTimer:
    """Lightweight rolling throughput meter; optionally journals to JSONL."""

    def __init__(self, window: int = 50, log_path: str | None = None):
        self.window = window
        self.times = []
        self._last = None
        self._f = open(log_path, "a") if log_path else None

    def tick(self, n_items: int = 1, sync=None):
        """Record the time since the last tick; ``sync`` (a device) is
        synchronized first."""
        if sync is not None:
            synchronize(sync)
        now = time.perf_counter()
        if self._last is not None:
            self.times.append((now - self._last, n_items))
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def items_per_sec(self) -> float:
        if not self.times:
            return 0.0
        dt = sum(t for t, _ in self.times)
        n = sum(n for _, n in self.times)
        return n / dt if dt > 0 else 0.0

    def log(self, step: int, **extra):
        if self._f is None:
            return
        self._f.write(json.dumps({"step": step,
                                  "items_per_sec": self.items_per_sec,
                                  **extra}) + "\n")
        self._f.flush()
