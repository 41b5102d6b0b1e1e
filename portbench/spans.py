"""The program's own spans (``copenerf_torch.utils.profiling``), read for
the per-layer metrics of a ``--trace 1`` run and for its per-span table on
standard error.

Two readings, each where its clock is honest:

* Device figures from the profiled stretch (``Record.trace``): the program's
  spans are ``record_function`` ranges there (``user_annotation`` events
  named ``copenerf.*``). A device operation belongs to every program span
  open on the thread that launched it (found by correlation, as
  ``Trace.top_gaps`` does); a thread with no program span open (the
  autograd engine's during a backward pass) continues into the program
  spans open at that moment on the thread that runs the window. Each idle
  gap of the card (``trace.gaps``) is split, by overlap, over the innermost
  program spans open during it on the thread that launched the operation
  ending it; time in none is "outside the program". A sync is a copy from
  the card to the host, or one from pageable host memory to the card: the
  host waits for the card's queue before either.
* Host figures from a third stretch that no profiler has touched, made
  by the host readers of a cell that has one: a fresh process of the same
  checkout (``python3 -m portbench.spans``) builds a driver of the cell
  from the run's seed on its device, warms it up and runs 2 x
  ``trace_units`` pairs of units, one plain and one inside
  ``record_spans()``, each timed on the host clock. A process that has
  run the profiler launches slower, and not evenly across the program's
  layers, so the run's own process does not make it. The recorded units'
  log gives each span's inclusive and self host time; their time against
  the plain units' is the cost of recording. A host span's time includes
  the host's waits at the syncs inside it.

A program without spans (no ``copenerf.*`` range in its profiled stretch)
gives no reading: every reader here then returns None. A spans stretch
that fails fails the run.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import subprocess
import sys
import time

from portbench import trace as tracing

PREFIX = "copenerf."
STEP = "copenerf.step"
KERNEL = "copenerf.kernel."
OUTSIDE = "outside the program"
PAGEABLE = "Pageable -> Device"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The profiled stretch
# ---------------------------------------------------------------------------

def timeline(ranges):
    """The (start, end, chain) segments of one thread's nested ranges
    (start, end, name) in which the open ranges do not change; ``chain`` is
    their names, innermost first. A range that ends after the range around
    it is cut at that range's end."""
    out, stack, t = [], [], None     # stack: [(end, name)], innermost last

    def emit(upto):
        nonlocal t
        if upto > t:
            out.append((t, upto, tuple(n for _, n in reversed(stack))))
            t = upto

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            emit(stack[-1][0])
            stack.pop()
        if stack:
            emit(a)
            b = min(b, stack[-1][0])
        t = a
        stack.append((b, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return out


class Layers:
    """The program's spans of one ``portbench.trace.Trace``."""

    def __init__(self, trace):
        self.trace = trace
        ranges = {key: [r for r in rs if r[2].startswith(PREFIX)]
                  for key, rs in trace.host.items()}
        self.lines = {key: timeline(rs) for key, rs in ranges.items() if rs}
        self.starts = {key: [s[0] for s in line]
                       for key, line in self.lines.items()}
        self.main = next((key for key, rs in trace.host.items()
                          if any(r[2] == tracing.WINDOW for r in rs)), None)

    @property
    def found(self) -> bool:
        return bool(self.lines) and bool(self.trace.device)

    def _segment(self, key, ts):
        i = bisect.bisect_right(self.starts.get(key, []), ts) - 1
        if i >= 0:
            seg = self.lines[key][i]
            if seg[1] >= ts:
                return seg
        return None

    def chain(self, key, ts) -> tuple:
        """The program spans open at ``ts`` on thread ``key``, innermost
        first, continued into the window's thread."""
        seg = self._segment(key, ts)
        own = seg[2] if seg else ()
        if key != self.main and self.main is not None:
            outer = self._segment(self.main, ts)
            own = own + (outer[2] if outer else ())
        return own

    def _launched(self, e):
        return self.trace.launch.get(e.get("args", {}).get("correlation"))

    def by_span(self) -> dict:
        """Per span name (and ``OUTSIDE``): seconds of the kernels launched
        under it, their count and the syncs under it (inclusive of the
        spans inside it), and the idle seconds put down to it as the
        innermost span."""
        rows = collections.defaultdict(
            lambda: {"device_s": 0.0, "launches": 0, "syncs": 0,
                     "idle_s": 0.0})
        for e in self.trace.device:
            where = self._launched(e)
            names = set(self.chain(where[:2], where[2])) if where else set()
            kernel = e.get("cat") == "kernel"
            sync = (e.get("cat") == "gpu_memcpy"
                    and ("DtoH" in e["name"] or PAGEABLE in e["name"]))
            for n in names or (OUTSIDE,):
                if kernel:
                    rows[n]["device_s"] += float(e["dur"]) * 1e-6
                    rows[n]["launches"] += 1
                rows[n]["syncs"] += int(sync)
        for chain, seconds in self.idle():
            rows[chain[0] if chain else OUTSIDE]["idle_s"] += seconds
        return dict(rows)

    def idle(self):
        """[(chain, seconds)]: every idle gap of the window split over the
        chains of program spans open during it on the thread that launched
        the operation ending it; parts in no span have the chain ()."""
        tr = self.trace
        ordered = sorted(tr.device, key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in ordered]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in ordered]
        out = []
        for a, b in tracing.gaps(spans, tr.lo, tr.hi):
            i = bisect.bisect_left(starts, b)
            where = self._launched(ordered[i]) if i < len(ordered) else None
            key = where[:2] if where else self.main
            for x, y, chain in self._split(key, a, b):
                out.append((chain, (y - x) * 1e-6))
        return out

    def _split(self, key, a, b):
        """(start, end, chain) pieces of [a, b] on thread ``key``; what no
        span of that thread covers falls to the window's thread, then to
        ()."""
        pieces, t = [], a
        for x, y, _ in self._covered(key, a, b):
            if x > t:
                pieces += self._rest(t, x)
            mid = 0.5 * (x + y)
            pieces.append((x, y, self.chain(key, mid)))
            t = y
        if t < b:
            pieces += self._rest(t, b)
        return pieces

    def _rest(self, a, b):
        if self.main is None:
            return [(a, b, ())]
        pieces, t = [], a
        for x, y, chain in self._covered(self.main, a, b):
            if x > t:
                pieces.append((t, x, ()))
            pieces.append((x, y, chain))
            t = y
        if t < b:
            pieces.append((t, b, ()))
        return pieces

    def _covered(self, key, a, b):
        """The segments of thread ``key`` clipped to [a, b]."""
        line = self.lines.get(key, [])
        i = max(0, bisect.bisect_right(self.starts.get(key, []), a) - 1)
        out = []
        for x, y, chain in line[i:]:
            if x >= b:
                break
            if y > a:
                out.append((max(x, a), min(y, b), chain))
        return out

    def glue_idle_share(self):
        """The share of the window's idle time put down to a span under
        ``copenerf.step`` and under no ``copenerf.kernel.*`` span."""
        pieces = self.idle()
        total = sum(s for _, s in pieces)
        if total <= 0:
            return None
        glue = sum(s for chain, s in pieces if STEP in chain
                   and not any(n.startswith(KERNEL) for n in chain))
        return glue / total


def layers(run):
    """The ``Layers`` of a traced run, made once, or None where the trace
    holds no program span or no device operation."""
    if run.trace is None:
        return None
    if "_spans_layers" not in run.__dict__:
        lay = Layers(run.trace)
        run.__dict__["_spans_layers"] = lay if lay.found else None
    return run.__dict__["_spans_layers"]


# ---------------------------------------------------------------------------
# The spans stretch
# ---------------------------------------------------------------------------

def has_spans(run) -> bool:
    """Whether the program of a traced run has spans: its profiled stretch
    holds a ``copenerf.*`` range (a program from before them has none)."""
    return run.trace is not None and any(
        r[2].startswith(PREFIX) for rs in run.trace.host.values() for r in rs)


def cell_call():
    """(seed, device) of the ``portbench/run.py`` ``run_cell`` call whose
    metrics are being read. ``Record`` carries neither, so they are read
    from that call's frame; a reader called outside one raises."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and \
                os.path.basename(f.f_code.co_filename) == "run.py":
            return int(f.f_locals["seed"]), str(f.f_locals["device"])
        f = f.f_back
    raise RuntimeError("the spans stretch is read inside run_cell only")


def host_table(log, wall_ns: int) -> dict:
    """Per span name: count, inclusive and self nanoseconds (its time less
    its children's) of a ``record_spans`` log; ``OUTSIDE`` holds the wall
    time outside every root span."""
    rows = collections.defaultdict(
        lambda: {"count": 0, "incl_ns": 0, "self_ns": 0})
    roots = 0
    for name, _, a, b, parent in log:
        r = rows[name]
        r["count"] += 1
        r["incl_ns"] += b - a
        r["self_ns"] += b - a
        if parent is None:
            roots += b - a
        else:
            rows[log[parent][0]]["self_ns"] -= b - a
    rows[OUTSIDE] = {"count": 0, "incl_ns": wall_ns - roots,
                     "self_ns": wall_ns - roots}
    return dict(rows)


def under(log, name: str, ancestor: str, prefix: bool = False):
    """Inclusive nanoseconds of the spans ``name`` (with ``prefix``, every
    span whose name starts with it) with a span ``ancestor`` around them."""
    total = 0
    for n, _, a, b, p in log:
        if not (n.startswith(name) if prefix else n == name):
            continue
        while p is not None and log[p][0] != ancestor:
            p = log[p][4]
        if p is not None:
            total += b - a
    return total


def measure(cfg: dict, mix: dict, seed: int, device: str) -> dict:
    """The spans stretch in this process: a driver of the cell built from
    ``seed`` and warmed up, then 2 x ``trace_units`` pairs of a plain and a
    recorded unit. Returns the recorded units' log, their count and the
    host nanoseconds of the recorded and the plain units."""
    import torch

    from copenerf_torch.utils import profiling
    from portbench import drivers

    drv = drivers.load(mix["kind"])(cfg, mix, seed, device)
    drv.warm_up()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    # The order within a pair swaps every pair: the host's speed drifts
    # over seconds by more than recording costs, and the pairs cancel the
    # drift.
    log, plain_ns, spans_ns = [], 0, 0
    units = 2 * int(mix["trace_units"])
    for i in range(units):
        for recorded in (i % 2 == 1, i % 2 == 0):
            if recorded:
                with profiling.record_spans() as part:
                    t0 = time.perf_counter_ns()
                    drv.unit()
                    spans_ns += time.perf_counter_ns() - t0
                off = len(log)
                log += [(n, t, a, b, None if p is None else p + off)
                        for n, t, a, b, p in part]
            else:
                t0 = time.perf_counter_ns()
                drv.unit()
                plain_ns += time.perf_counter_ns() - t0
    drv.release()
    return {"log": log, "units": units, "spans_ns": spans_ns,
            "plain_ns": plain_ns}


def stretch(run):
    """The spans stretch of a traced run, made once, in a fresh process of
    the same checkout, seed and device: a process that has run the
    profiler launches slower, and not evenly across the program's layers.
    None where the program has no spans; a stretch that fails raises."""
    if "_spans_stretch" in run.__dict__:
        return run.__dict__["_spans_stretch"]
    out = None
    if has_spans(run):
        import torch

        seed, device = cell_call()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        request = {"cfg": run.cfg, "mix": run.mix, "seed": seed,
                   "device": device,
                   "tf32": [torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32]}
        done = subprocess.run(
            [sys.executable, "-m", "portbench.spans", "--stdin"],
            cwd=ROOT, input=json.dumps(request), stdout=subprocess.PIPE,
            text=True, timeout=1800)
        if done.returncode != 0:
            raise RuntimeError(f"the spans stretch exited with "
                               f"{done.returncode}")
        out = json.loads(done.stdout.strip().splitlines()[-1])
        out["table"] = host_table(out["log"], out["spans_ns"])
    run.__dict__["_spans_stretch"] = out
    return out


def host_ms(run, kind, name, ancestor=None, less=None):
    """Inclusive host ms a unit of span ``name`` (within ``ancestor``) in
    the spans stretch of a ``kind`` run; with ``less``, less the spans
    inside it whose names start with ``less``."""
    if run.kind != kind or run.trace is None:
        return None
    st = stretch(run)
    if st is None or name not in st["table"]:
        return None
    ns = (under(st["log"], name, ancestor) if ancestor
          else st["table"][name]["incl_ns"])
    if less:
        ns -= under(st["log"], less, name, prefix=True)
    report(run)
    return ns * 1e-6 / st["units"]


# ---------------------------------------------------------------------------
# The table on standard error
# ---------------------------------------------------------------------------

def report(run, out=None) -> None:
    """Print the per-span table of a traced run once (standard error), at
    the first reader of spans; its host columns where a host metric of the
    cell made the spans stretch before it (the host readers come first in
    ``BENCHMARK.json``)."""
    if run.__dict__.get("_spans_reported"):
        return
    run.__dict__["_spans_reported"] = True
    out = out or sys.stderr
    st = run.__dict__.get("_spans_stretch")
    lay = layers(run)
    if st is None and lay is None:
        return
    dev = lay.by_span() if lay else {}
    table(st, dev, max(run.units, 1), out)
    if dev:
        idle = sum(r["idle_s"] for r in dev.values())
        inside = idle - dev.get(OUTSIDE, {}).get("idle_s", 0.0)
        if idle > 0:
            print(f"idle in program spans: {100 * inside / idle:.1f}% of "
                  f"{idle * 1e3:.3f} ms", file=out)


def table(st, dev: dict, units: int, out) -> None:
    """The per-span table: host columns from the spans stretch ``st`` (or
    none), device columns from ``Layers.by_span`` rows over ``units``
    profiled units (or none), then the cost of recording."""
    host = st["table"] if st else {}
    per = st["units"] if st else 1
    print(f"spans: per unit; host ms from {per if st else 'no'} units "
          f"recorded, device from the {units if dev else 'no'} profiled",
          file=out)
    print(f"{'span':<36}{'count':>7}{'host incl':>11}{'host self':>11}"
          f"{'device':>10}{'launches':>10}{'idle':>9}{'syncs':>7}",
          file=out)
    names = sorted(set(host) | set(dev),
                   key=lambda k: -host.get(k, {}).get("incl_ns", 0))
    for k in names:
        h, d = host.get(k), dev.get(k)
        cells = [f"{h['count'] / per:7.2f}" if h else f"{'-':>7}",
                 f"{h['incl_ns'] * 1e-6 / per:11.3f}" if h else f"{'-':>11}",
                 f"{h['self_ns'] * 1e-6 / per:11.3f}" if h else f"{'-':>11}",
                 f"{d['device_s'] * 1e3 / units:10.3f}" if d else f"{'-':>10}",
                 f"{d['launches'] / units:10.1f}" if d else f"{'-':>10}",
                 f"{d['idle_s'] * 1e3 / units:9.3f}" if d else f"{'-':>9}",
                 f"{d['syncs'] / units:7.2f}" if d else f"{'-':>7}"]
        print(f"{k:<36}" + "".join(cells), file=out)
    if st:
        total = sum(r["self_ns"] for r in host.values())
        print(f"host: spans and outside {total * 1e-6 / per:.3f} ms a unit "
              f"of {st['spans_ns'] * 1e-6 / per:.3f}; plain "
              f"{st['plain_ns'] * 1e-6 / per:.3f}", file=out)
        print(f"spans on: {st['spans_ns'] / st['plain_ns'] - 1:+.4f}",
              file=out)


def main(argv=None) -> int:
    """``python3 -m portbench.spans --workload <cell> --seed <n>`` runs a
    cell's spans stretch alone (on the card unless ``--device`` says
    otherwise, TF32 off as in ``portbench/run.py``) and prints its host
    table on standard error; ``--stdin`` takes the configuration, mix,
    seed, device and TF32 flags as one JSON object on standard input, as a
    traced run's readers send it. Either way the last line of standard
    output is the stretch as JSON."""
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stdin", action="store_true")
    args = ap.parse_args(argv)
    if args.stdin:
        req = json.load(sys.stdin)
    elif args.workload is not None and args.seed is not None:
        from portbench.run import load_json

        bench = load_json("BENCHMARK.json")
        cell = next(w for w in bench["workloads"]
                    if w["name"] == args.workload)
        req = {"cfg": load_json("portbench", "configs",
                                f"{cell['config']}.json"),
               "mix": load_json("portbench", "traffic",
                                f"{cell['traffic']}.json"),
               "seed": args.seed, "device": args.device,
               "tf32": [False, False]}
    else:
        ap.error("give --stdin, or --workload and --seed")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(req["tf32"][0])
    torch.backends.cudnn.allow_tf32 = bool(req["tf32"][1])
    st = measure(req["cfg"], req["mix"], int(req["seed"]), req["device"])
    if not args.stdin:
        table(dict(st, table=host_table(st["log"], st["spans_ns"])), {}, 1,
              sys.stderr)
    print(json.dumps(st), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
