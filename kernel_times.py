#!/usr/bin/env python3
"""CUDA-event times of the port's kernels that predate the fold (K1-K5) at
the train step's shapes, one JSON line.

    python3 kernel_times.py [--root DIR] [--label NAME]

Times every launcher of K2, K1, K3, K4 and K5 on 131,072 rows (K2 on
65,536) of the full-width nets of ``configs/default.yaml``, their
geometric init perturbed with ``perturb_``, random inputs and cotangents
from fixed seeds, each the mean of ``REPS`` launches after a warm-up.
``--root`` imports ``copenerf_torch`` (and builds its kernels) from another
checkout, e.g. a parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, so two versions compare on one card in
one call, in turns: ``--root A``, ``--root B``, ``--root B``, ``--root A``.
Needs a CUDA card; prints the card's ``nvidia-smi`` name and power limit
first.
"""

import argparse
import json
import os
import subprocess
import sys

ROWS = 131072
REPS = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)

    import torch
    from copenerf_torch.models import fields as F
    from copenerf_torch.models.mlp import perturb_
    from copenerf_torch.ops.kernels import build, pack
    from copenerf_torch.ops.kernels import color as CK
    from copenerf_torch.ops.kernels import outgrad as OG
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.load_library()
    g = torch.Generator().manual_seed(1)
    sdf = perturb_(F.SDFNetwork(F.SDFConfig(), torch.Generator().manual_seed(0)), g)
    col = perturb_(F.ColorNetwork(F.ColorConfig(), torch.Generator().manual_seed(0)), g)
    sdf, col = sdf.cuda(), col.cuda()
    scfg, ccfg = sdf.cfg, col.cfg
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    n = ROWS
    x = rand(n, 4) * 0.6
    d = torch.nn.functional.normalize(rand(n, 3), dim=-1)
    sbar, gbar, cbar, obar = rand(n, 1), rand(n, 4), rand(n, 3), rand(n, scfg.d_out)
    with torch.no_grad():
        rc = pack.pack_rendercore(sdf, col)
        val = pack.pack_sdf_value_layers(pack.effective_layers(sdf), with_wt=True)
        og, cl = pack.pack_outgrad(sdf), pack.pack_color(col)
        out, grad = OG.launch_outgrad_fwd(scfg, og, x)
    feat = out[:, 1:]
    fns = {
        "sdf_value_65536": lambda: SVD.launch_value(scfg, val, x[:n // 2], SVD.FWD_COUNTER),
        "rendercore_fwd": lambda: RC.launch_fwd(scfg, ccfg, rc, x, d),
        "rendercore_bwd": lambda: RC.rendercore_bwd_cuda(scfg, ccfg, rc, x, d, sbar,
                                                         gbar, cbar),
        "sdf_value_diff_fwd": lambda: SVD.launch_value(scfg, val, x, SVD.FWD_COUNTER),
        "sdf_value_bwd": lambda: SVD.sdf_value_bwd_cuda(scfg, val, x, sbar[:, 0]),
        "sdf_outgrad_fwd": lambda: OG.launch_outgrad_fwd(scfg, og, x),
        "sdf_outgrad_bwd": lambda: OG.outgrad_bwd_cuda(scfg, og, x, obar, gbar),
        "color_fwd": lambda: CK.launch_color_fwd(ccfg, cl, x, d, grad, feat),
        "color_bwd": lambda: CK.color_bwd_cuda(ccfg, cl, x, d, grad, feat, cbar),
    }
    ms = {}
    with torch.no_grad():
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end) / REPS
    print(json.dumps({"label": a.label, "root": root, "rows": n, "reps": REPS,
                      "card": torch.cuda.get_device_name(0), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
