"""Spans, step timing and profiler traces (port of
``copenerf_tpu/utils/profiling.py``).

``span(name)`` marks a region of the program (dotted names under
``copenerf.``; ``spanned(name)`` is its decorator form). Off, it is one
check of module state and a shared no-op. While a ``torch.profiler`` is
active it enters ``record_function(name)``, so the region lands in the
profiler's Chrome trace beside the kernels it launched; while
``record_spans()`` records, it appends ``(name, thread, start_ns, end_ns,
parent)`` to the recording's log. A span never synchronizes the device and
never touches a tensor.

``StepTimer`` is the JSONL journal of the ``Trainer``. ``trace`` is the
counterpart of the JAX package's ``jax.profiler`` trace: a
``torch.profiler`` capture exported as a Chrome trace, summarized as the
window's wall time and the device's busy share.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class _Off:
    """The span of a region while nothing records and no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_RECORDING = None            # the active ``_Recording``, if any
_THREAD = threading.local()  # .stack: the spans open on this thread


class _Recording:
    def __init__(self):
        self.closed = []                 # _Span objects, as they close
        self.stack = _open_stack()       # the recording thread's


def _open_stack() -> list:
    stack = getattr(_THREAD, "stack", None)
    if stack is None:
        stack = _THREAD.stack = []
    return stack


class _Span:
    __slots__ = ("name", "rf", "rec", "stack", "parent", "thread", "start",
                 "end")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = rec = _RECORDING
        if rec is not None:
            self.stack = stack = _open_stack()
            # On a thread with no open span (autograd's device thread in a
            # backward pass) the region belongs to the recording thread's
            # innermost span.
            outer = stack or rec.stack
            self.parent = outer[-1] if outer else None
            self.thread = threading.get_ident()
            stack.append(self)
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            self.end = time.perf_counter_ns()
            self.stack.pop()
            rec.closed.append(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one region of the program named ``name``;
    see the module's docstring."""
    if _RECORDING is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def record_spans():
    """Record every span of the block, on any thread; yields the log, a
    list that is filled when the block ends with one
    ``(name, thread, start_ns, end_ns, parent)`` per span in the order they
    closed: ``thread`` is ``threading.get_ident()``, the times are
    ``time.perf_counter_ns()``, and ``parent`` is the index in the log of
    the innermost span open on the same thread when it opened (on a thread
    with none open, on the recording thread), or None for a root."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("record_spans() is already recording")
    rec = _RECORDING = _Recording()
    log = []
    try:
        yield log
    finally:
        _RECORDING = None
        index = {id(s): i for i, s in enumerate(rec.closed)}
        log.extend((s.name, s.thread, s.start, s.end,
                    index.get(id(s.parent))) for s in rec.closed)


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
    """The JSONL journal of a run (``logs/throughput.jsonl``): one line a
    ``log`` call, flushed as it is written."""

    def __init__(self, log_path: str | None = None):
        self._f = open(log_path, "a") if log_path else None

    def log(self, step: int, **extra):
        if self._f is None:
            return
        self._f.write(json.dumps({"step": step, **extra}) + "\n")
        self._f.flush()
