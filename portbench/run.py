"""Run one benchmark cell of the PyTorch and CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``workloads`` in ``BENCHMARK.json``)
names a configuration (``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``, read by the driver of its ``kind``,
``portbench/drivers/<kind>.py``). The run makes its inputs on the card from
the seed, sets up and warms up the program's entry, then measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or profiles
the mix's ``trace_units`` units (``--trace 1``: its per-layer metrics).
Each metric is read by ``portbench/metrics/<name>.py``. After the window
the program is freed and the plain reference recomputes the first units;
the numbers compared are held to ``portbench/limits/<cell>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``, each number compared beside its limit; the same
numbers end standard error. Without a CUDA card, or with fewer than the cell
asks for, or where the card cannot be named, or where JAX or the JAX package
was loaded, the run prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that the port's run may not load: JAX, its
# libraries and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "copenerf_tpu")


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""
    cfg: dict
    mix: dict
    kind: str
    units: int
    rays_per_unit: int
    unit_flop: float         # the model's operations in one unit
    window_s: float
    setup_s: float
    unit_ms: list
    trace: object = None     # the traced stretch (portbench.trace.Trace)
    plain_s: float = None    # the same number of units untraced, seconds


class UnitClock:
    """Per-unit times: CUDA events recorded after each unit on the card
    (read after the window's closing sync), the host clock elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.torch = torch
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def unit_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", cfg=None, mix=None) -> dict:
    """One run of cell ``workload``; returns the result object. ``cfg`` and
    ``mix`` replace the cell's files (the tests' small sizes)."""
    import torch

    from portbench import drivers
    from portbench import trace as tracing

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = cfg or load_json("portbench", "configs", f"{cell['config']}.json")
    mix = mix or load_json("portbench", "traffic", f"{cell['traffic']}.json")
    limits = load_json("portbench", "limits", f"{workload}.json")
    t_built = time.perf_counter()
    drv = drivers.load(mix["kind"])(cfg, mix, seed, device)
    sync(device)
    t_warm = time.perf_counter()
    drv.warm_up()
    sync(device)
    print(f"setup: {t_built - T_START:.3f} s to the generator, "
          f"{t_warm - t_built:.3f} s inputs and program, "
          f"{time.perf_counter() - t_warm:.3f} s first units and warm-up",
          file=sys.stderr)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    held = None
    units = 0
    plain_s = None
    if trace:
        # The same number of units untraced first: the profiler's own host
        # cost stretches a host-bound unit, so rates and idle shares take
        # this stretch's wall time.
        t0 = time.perf_counter()
        for _ in range(int(mix["trace_units"])):
            drv.unit()
        sync(device)
        plain_s = time.perf_counter() - t0
        with tracing.capture(device) as holder:
            clock = UnitClock(device)
            for _ in range(int(mix["trace_units"])):
                drv.unit()
                clock.mark()
                units += 1
        held = holder["trace"]
        window_s = held.window_s
    else:
        clock = UnitClock(device)
        t0 = time.perf_counter()
        while True:
            drv.unit()
            clock.mark()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
    unit_ms = clock.unit_ms()
    ms = sorted(unit_ms)
    if ms:
        print(f"units: {len(ms)} in {window_s:.3f} s; ms median "
              f"{ms[len(ms) // 2]:.3f}, p90 {ms[int(0.9 * (len(ms) - 1))]:.3f}, "
              f"max {ms[-1]:.3f}", file=sys.stderr)
    attempted, failed = drv.counts()
    dev = torch.device(device)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    record = Record(cfg=cfg, mix=mix, kind=mix["kind"], units=units,
                    rays_per_unit=drv.rays_per_unit,
                    unit_flop=drv.unit_flop(), window_s=window_s,
                    setup_s=setup_s, unit_ms=unit_ms, trace=held,
                    plain_s=plain_s)
    prog = drv.readings
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.compare(prog, drv.reference("f32"))
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in checks.items()) and failed == 0
    group = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in group:
        if applies(m, workload):
            value = reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name()
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=held.busy_s, window_s=held.window_s)
        result["breakdown"] = {"device_ops": held.top_ops(),
                               "idle_gaps": held.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def device_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible: no result", file=sys.stderr)
        return 2
    try:
        card = device_line()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        print(f"cannot name the card ({exc!r}): no result", file=sys.stderr)
        return 2
    if not torch.cuda.get_device_name():
        print("the card reports no name: no result", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    result["device"]["nvidia_smi"] = card
    checks = result.pop("checks")
    result["checks"] = checks          # the last key of the line
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
