"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the program's (its first units as a run takes them; for the render
the views of a run's window) and the control's, the plain reference computed
in TF32 (the precision below the configuration's f32 with TF32 off) put in
the program's place. The limits in ``portbench/limits/`` are set between the
program's largest reading and the control's smallest.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--control-seeds 1 2 3] [--units 6] [--fault half_batch]

Prints one JSON line per seed and side, then one summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(bench, workload, seed, units, device="cuda", cfg=None, mix=None,
             control=True, fault=None):
    """{"program": gaps, "control": gaps} of one seed: the program's first
    units (and ``units`` window units of a render) against the f32
    reference, and the TF32 reference against it. With ``fault`` the
    program runs with that fault planted (``portbench.faults``)."""
    import contextlib

    import torch

    from portbench import drivers, faults
    from portbench.drivers._common import look
    from portbench.run import load_json

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = cfg or load_json("portbench", "configs", f"{cell['config']}.json")
    mix = mix or load_json("portbench", "traffic", f"{cell['traffic']}.json")
    with (faults.planted(fault, mix["kind"]) if fault
          else contextlib.nullcontext()):
        drv = drivers.load(mix["kind"])(cfg, mix, seed, device)
        drv.warm_up()
        if mix["kind"] == "render":
            for _ in range(units):
                drv.unit()
        prog = drv.readings
    drv.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference("f32")
    out = {"program": drv.compare(prog, ref)}
    if isinstance(ref, dict):
        out["look"] = look(prog, ref)
    if control:
        ctl = drv.reference("tf32")
        out["control"] = drv.compare(ctl, ref)
        if isinstance(ref, dict):
            out["control_look"] = look(ctl, ref)
    return out


def main(argv=None) -> int:
    import torch

    from portbench.run import load_json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--units", type=int, default=6,
                    help="views a render seed renders (a run's window)")
    ap.add_argument("--fault", default=None,
                    help="plant this fault in the program (portbench.faults)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = load_json("BENCHMARK.json")
    control = set(args.seeds if args.control_seeds is None
                  else args.control_seeds)
    worst = {}
    for seed in args.seeds:
        r = readings(bench, args.workload, seed, args.units,
                     control=seed in control, fault=args.fault)
        for side, gaps in r.items():
            print(json.dumps({"seed": seed, "side": side, **gaps}), flush=True)
            if side.endswith("look"):
                continue
            for k, v in gaps.items():
                key = (side, k)
                pick = max if side == "program" else min
                worst[key] = v if key not in worst else pick(worst[key], v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload,
                      "program_max": {k: v for (s, k), v in worst.items()
                                      if s == "program"},
                      "control_min": {k: v for (s, k), v in worst.items()
                                      if s == "control"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
