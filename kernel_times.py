#!/usr/bin/env python3
"""CUDA-event times of the port's kernels at the main path's shapes, each
split into the device time of every CUDA kernel its launcher runs, one JSON
line; with ``--trial``, the accuracy trial of the tensor-core core instead.

    python3 kernel_times.py [--root DIR] [--label NAME]
    python3 kernel_times.py --trial
    python3 kernel_times.py --e2e-draws N [--root DIR] [--label NAME]

Times every launcher of K1-K7 on 131,072 rows (the train step's field
queries; K2 on 65,536 and on 2,097,152, a render chunk's first sweep;
K1-fwd, K4-fwd and K5-fwd also on 4,194,304, a render chunk's render core)
of the full-width nets of ``configs/default.yaml``, their geometric init perturbed
with ``perturb_``, random inputs and cotangents from fixed seeds: the mean of
``REPS`` launches after a warm-up (CUDA events), then the same launches under
``torch.profiler`` (CUDA activity), whose device time per kernel name gives
the split (each backward: its row kernel, ``wgrad_wg_partial_kernel`` and
``wgrad_final_kernel``, each as ms per launch beside the launches the
profiler recorded; "not measured" where it sees no device time;
``rendercore_bwd_frozen``, K1-bwd for frozen fields, runs its row kernel
alone, and a tree without it has no such row); beside
them ``torch.mm`` of every backward's weight reduction over
random rows of its staged widths, one product a job
(``<launcher>_reduction_mm`` for K1, K3-K7: yardsticks the port never
calls) and the reductions' bounds (3xTF32 products; staged bytes), the
registers and spill bytes of the tensor-core kernels (K1-K7,
the reduction; K1-bwd's frozen-fields overload as
``rendercore_bwd_kernel<0> frozen``) and any ptxas line about the wgmma
pipeline,
``value_step_16384``: a K2 and a K3-fwd launch on 16,384 rows each after a
weight update, so with the weight packing a train step does for them, and
``color_pack``: the color pack ``pack.pack_color`` builds on a cache miss
(its events' time is the host's, its profiler split the device's).
``--root`` imports ``copenerf_torch`` (and builds its kernels) from
another checkout, e.g. a parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, so two versions compare on one card in
one call, in turns: ``--root A``, ``--root B``, ``--root B``, ``--root A``.

``--trial`` holds the tile GEMM of every row kernel (``wgmma``) and the
weight-gradient reduction (``csrc/tc_check.cu``) against an f64 product at
the shapes the kernels multiply (K = 52, 204, 256, 292), in every variant
(f32 FFMA; wgmma in 3xTF32 as shipped with a two-stage and a one-stage
ring, and in 1xTF32; the reduction in FFMA, as shipped on wgmma and in
1xTF32), and times each tile GEMM's slope (the FFMA control, ``wgmma``
with the weights packed by the host through either ring).

``--e2e-draws N`` reports K1-bwd's accuracy at the small nets of the
whole-pipeline head-to-head (``e2e_port.py``): seed 0 of its run on the
card, K1-bwd's rows at its most launched row count captured by
``chip_smoke.launch_rows``, then for N cotangent draws on those rows (the
smoke's check: sbar, gbar, cbar alone, no color cotangent within
KINK_MARGIN of a color ReLU's kink) each channel's worst gradient tensor's
error against f64 over the smoke's bound (2x the plain f32 version's
error, or 1e-5 of the tensor's norm; above 1 misses it) and the geometric
mean over the tensors of the kernel's error over the plain version's. A
report, no gate; with ``--root`` the kernels and the run are that tree's
(``chip_smoke.py`` and ``e2e_port.py`` are this one's).

Needs a CUDA card; prints the card's ``nvidia-smi`` name and power limit
first.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROWS = 131072
CHUNK_ROWS = 32768 * 128
REPS = 10


def event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(fn, reps):
    """{CUDA kernel name: {"ms": device ms per launch, "launches": launches
    recorded}} from torch.profiler over ``reps`` calls of fn after one
    warm-up call inside the profiler (CUPTI's first records of a window can
    be lost), or None when it records no device time. A launcher's kernel
    that runs once a call shows ``launches`` == reps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
        for _ in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us <= 0 or ev.count <= 0:
            continue
        m = re.search(r"(\w+_kernel)(<[^>(]*>)?", ev.key)
        name = m.group(1) + (m.group(2) or "") if m else ev.key[:60]
        got = split.setdefault(name, {"us": 0.0, "launches": 0})
        got["us"] += us
        got["launches"] += ev.count
    return {k: {"ms": v["us"] / 1e3 / v["launches"], "launches": v["launches"]}
            for k, v in split.items()} or None


def registers(log):
    """{kernel: (registers, spill stores, spill loads)} from ptxas -v."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)"
                      r"(I(?:L(?:b|i|N\w+?E)\d+E)+E)?", ln)
        if m:
            name = m.group(1) + ("<%s>" % ",".join(
                re.findall(r"L(?:b|i|N\w+?E)(\d+)E", m.group(2))) if m.group(2) else "")
            name += " frozen" if "FrozenFields" in ln else ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return out


def reduction_shapes(kernel, scfg, ccfg, n):
    """[(rows, O, I)], one a job (a job's pairs as one product over their
    rows), of a backward kernel's weight reduction:

    * ``sdf_value_bwd`` (K3): each SDF layer on n rows, the head's column 0;
    * ``sdf_out_bwd`` (K7): the same with the whole head;
    * ``sdf_outgrad_bwd`` (K4): each hidden layer's two pairs (2n rows), the
      whole head, and the head's row-0 extra (ones over the last hidden
      layer's output, as the kernel stages it);
    * ``rendercore_bwd`` (K1): K4's jobs and the color layers';
    * ``rendercore_cons_bwd`` (K6): K1's, the hidden layers' first pair and
      the head also over the y rows (3n and 2n rows);
    * ``color_bwd`` (K5): the color layers' (layer 0 k0 wide, the head 3).
    """
    from copenerf_torch.models.fields import idr_layer_dims
    from copenerf_torch.ops.kernels.pack import color_k0

    sdf_kinds = {"sdf_value_bwd": (1, 1), "sdf_out_bwd": (1, 1), "sdf_outgrad_bwd": (2, 1),
                 "rendercore_bwd": (2, 1), "rendercore_cons_bwd": (3, 2)}
    shapes = []
    if kernel in sdf_kinds:
        hidden_rows, head_rows = sdf_kinds[kernel]
        for l in range(len(scfg.dims) - 2):
            i, o = idr_layer_dims(scfg, l)
            shapes.append((hidden_rows * n, o, i))
        head = 1 if kernel == "sdf_value_bwd" else scfg.d_out
        shapes.append((head_rows * n, head, scfg.d_hidden))
        if hidden_rows > 1:        # the head's row-0 extra
            shapes.append((n, 1, scfg.d_hidden))
    if kernel in ("rendercore_bwd", "rendercore_cons_bwd", "color_bwd"):
        dims = list(ccfg.dims)
        dims[0] = color_k0(ccfg)
        shapes += [(n, dims[l + 1], dims[l]) for l in range(len(dims) - 1)]
    return shapes


def reduction_pairs(kernel, scfg, ccfg, n, gen):
    """Random (z (rows, O), t (rows, I)) pairs of ``reduction_shapes``, for
    a ``torch.mm`` yardstick of the reduction."""
    import torch

    return [tuple(torch.randn((r, w), generator=gen, device=gen.device) for w in (o, i))
            for r, o, i in reduction_shapes(kernel, scfg, ccfg, n)]


def reduction_bounds(kernel, scfg, ccfg, n):
    """The least time of a backward's weight reduction on an H100 SXM
    (NVIDIA data sheet): its products in 3xTF32 (3 x 2 rows O I FLOP at 495
    TFLOP/s), and the staged rows read once and the gradients written once
    at 3.35 TB/s (the partial sums, the design's own traffic, left out)."""
    shapes = reduction_shapes(kernel, scfg, ccfg, n)
    flop = sum(2 * r * o * i for r, o, i in shapes)
    nbytes = 4 * sum(r * (o + i) + o * i + o for r, o, i in shapes)
    return {"tc_bound_ms": 1e3 * 3 * flop / 495e12, "bytes_bound_ms": 1e3 * nbytes / 3.35e12}


# The backward launchers with a torch.mm yardstick of their reduction.
REDUCTION_MM = ("rendercore_bwd", "rendercore_cons_bwd", "sdf_value_bwd", "sdf_outgrad_bwd",
                "color_bwd", "sdf_out_bwd")


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def run_times(label, root):
    import torch
    from copenerf_torch.models import fields as F
    from copenerf_torch.models.mlp import perturb_
    from copenerf_torch.ops.kernels import build, pack
    from copenerf_torch.ops.kernels import color as CK
    from copenerf_torch.ops.kernels import outgrad as OG
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import rendercore_cons as RCC
    from copenerf_torch.ops.kernels import sdf_out as SO
    from copenerf_torch.ops.kernels import sdf_value as SV
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

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
    y = rand(n, 4) * 0.6
    d = torch.nn.functional.normalize(rand(n, 3), dim=-1)
    xc = rand(CHUNK_ROWS, 4) * 0.6
    xv = xc[:CHUNK_ROWS // 2]
    dc = torch.nn.functional.normalize(rand(CHUNK_ROWS, 3), dim=-1)
    sbar, gbar, cbar, obar = rand(n, 1), rand(n, 4), rand(n, 3), rand(n, scfg.d_out)
    swbar = rand(n)
    with torch.no_grad():
        rc = pack.pack_rendercore(sdf, col)
        try:              # a tree that packs W^T only on request (--root)
            val = pack.pack_sdf_value_layers(pack.effective_layers(sdf), with_wt=True)
        except TypeError:
            val = pack.pack_sdf_value_layers(pack.effective_layers(sdf))
        og, cl = pack.pack_outgrad(sdf), pack.pack_color(col)
        out, grad = OG.launch_outgrad_fwd(scfg, og, x)
        out_c, grad_c = OG.launch_outgrad_fwd(scfg, og, xc)
        col_layers = pack.effective_layers(col)
    feat = out[:, 1:]
    p0 = next(sdf.parameters())

    def value_step():
        """What a train step spends on the value kernels' weights after an
        optimizer step: a new parameter version (the packs' caches miss),
        one K2 launch through ``sdf_value`` and one K3-fwd through
        ``sdf_value_diff``, each on 16,384 rows, the packing included."""
        p0.add_(0.0)
        SV.sdf_value_cuda(sdf, x[:n // 8])
        with torch.enable_grad():
            SVD.sdf_value_diff(sdf, x[:n // 8])

    fns = {
        "value_step_16384": value_step,
        "sdf_value_65536": lambda: SVD.launch_value(scfg, val, x[:n // 2], SVD.FWD_COUNTER),
        "sdf_value_2097152": lambda: SVD.launch_value(scfg, val, xv, SVD.FWD_COUNTER),
        "rendercore_fwd": lambda: RC.launch_fwd(scfg, ccfg, rc, x, d),
        "rendercore_fwd_4194304": lambda: RC.launch_fwd(scfg, ccfg, rc, xc, dc),
        "rendercore_bwd": lambda: RC.rendercore_bwd_cuda(scfg, ccfg, rc, x, d, sbar,
                                                         gbar, cbar),
        "sdf_value_diff_fwd": lambda: SVD.launch_value(scfg, val, x, SVD.FWD_COUNTER),
        "sdf_value_bwd": lambda: SVD.sdf_value_bwd_cuda(scfg, val, x, sbar[:, 0]),
        "sdf_outgrad_fwd": lambda: OG.launch_outgrad_fwd(scfg, og, x),
        "sdf_outgrad_fwd_4194304": lambda: OG.launch_outgrad_fwd(scfg, og, xc),
        "sdf_outgrad_bwd": lambda: OG.outgrad_bwd_cuda(scfg, og, x, obar, gbar),
        "color_fwd": lambda: CK.launch_color_fwd(ccfg, cl, x, d, grad, feat),
        "color_fwd_4194304": lambda: CK.launch_color_fwd(ccfg, cl, xc, dc, grad_c,
                                                         out_c[:, 1:]),
        "color_bwd": lambda: CK.color_bwd_cuda(ccfg, cl, x, d, grad, feat, cbar),
        "color_pack": lambda: pack.pack_color_layers(col_layers, ccfg),
        "rendercore_cons_fwd": lambda: RCC.launch_cons_fwd(scfg, ccfg, rc, x, d, y),
        "rendercore_cons_bwd": lambda: RCC.rendercore_cons_bwd_cuda(
            scfg, ccfg, rc, x, d, y, sbar, gbar, cbar, swbar),
        "sdf_out_fwd": lambda: SO.launch_out_fwd(scfg, og, x),
        "sdf_out_bwd": lambda: SO.sdf_out_bwd_cuda(scfg, og, x, obar),
    }
    if hasattr(RC, "rendercore_bwd_frozen_cuda"):    # --root may lack it
        fns["rendercore_bwd_frozen"] = lambda: RC.rendercore_bwd_frozen_cuda(
            scfg, ccfg, rc, x, d, sbar, cbar)
    # Each backward's reduction as torch.mm of its staged pairs (made just
    # before they are timed, freed after).
    for k in REDUCTION_MM:
        fns[k + "_reduction_mm"] = k
    ms, split = {}, {}
    with torch.no_grad():
        for name, fn in fns.items():
            pairs = None
            if isinstance(fn, str):
                pairs = reduction_pairs(fn, scfg, ccfg, n, gen)
                fn = lambda: [torch.mm(z.t(), t) for z, t in pairs]    # noqa: E731
            reps = 3 if name in ("rendercore_fwd_4194304", "sdf_outgrad_fwd_4194304",
                                 "color_fwd_4194304", "sdf_value_2097152") else REPS
            ms[name] = event_ms(fn, reps)
            split[name] = kernel_split(fn, reps) or "not measured"
            del pairs
            torch.cuda.empty_cache()
    log = build.build_log()
    regs = {k: v for k, v in registers(log).items()
            if re.search(r"rendercore|wgrad|sdf_value|sdf_out|color_", k)}
    print(json.dumps({"label": label, "root": root, "rows": n, "chunk_rows": CHUNK_ROWS,
                      "reps": REPS, "card": torch.cuda.get_device_name(0), "ms": ms,
                      "kernel_ms": split, "reduction_bounds": {
                          k: reduction_bounds(k, scfg, ccfg, n) for k in REDUCTION_MM},
                      "registers_spill_st_ld": regs,
                      "wgmma_warnings": [ln.strip() for ln in log.splitlines()
                                         if "wgmma" in ln]}), flush=True)


def run_trial():
    """Relative Frobenius errors against f64 of the tile GEMM (m rows of
    64-row tiles, K x N weights) and the reduction (n rows, O x I), for
    activations >= 0 (softplus, ReLU outputs) and of either sign
    (cotangents), weights N(0, 1/K); then times of the tile GEMM in every
    mode."""
    import torch
    from copenerf_torch.ops.kernels import build
    from copenerf_torch.ops.kernels import tc_check as TC

    build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(3)
    m = 64 * 132
    res = {"tile_gemm": {}, "reduction": {}}
    for K, N in ((52, 256), (256, 256), (256, 204), (204, 256), (292, 256), (256, 52)):
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        for kind in ("nonneg", "signed"):
            a = torch.randn((m, K), generator=gen, device="cuda")
            a = a.abs() if kind == "nonneg" else a
            ref = a.double() @ w.double()
            res["tile_gemm"][f"64x{K}x{N} {kind}"] = {
                mode: TC.rel_err(TC.tile_gemm(a, w, mode), ref)
                for mode in TC.MODES}
    for n, O, I in ((1024, 256, 256), (131072, 256, 256)):
        for kind in ("nonneg", "signed"):
            z = torch.randn((n, O), generator=gen, device="cuda")
            t = torch.randn((n, I), generator=gen, device="cuda")
            t = t.abs() if kind == "nonneg" else t
            ref = z.double().T @ t.double()
            res["reduction"][f"{n}x{O}x{I} {kind}"] = {
                mode: TC.rel_err(TC.row_reduce(z, t, O, I, mode)[0], ref)
                for mode in TC.REDUCE_MODES}
    # The tile GEMM alone: each block repeats it, so the slope over the
    # repeats is one 64 x 256 x 256 GEMM per tile of ROWS rows, without and
    # with the epilogue's load-after-store chain.
    a = torch.randn((ROWS, 256), generator=gen, device="cuda").abs()
    w = torch.randn((256, 256), generator=gen, device="cuda") / 16
    aux = torch.rand((2 * ROWS * 256,), generator=gen, device="cuda")
    times = {"note": f"{ROWS} rows x 256 x 256 per GEMM: ms from the slope over "
                     "1 and 9 repeats, TFLOP/s of f32 products"}
    for mode in TC.MODES:
        for chain in (None, aux):
            t1 = event_ms(lambda: TC.tile_gemm(a, w, mode, 1, chain), REPS)
            t9 = event_ms(lambda: TC.tile_gemm(a, w, mode, 9, chain), REPS)
            per = (t9 - t1) / 8
            key = mode + (" epilogue chain" if chain is not None else "")
            times[key] = {"ms_1_rep": t1, "ms_per_gemm": per,
                          "tflops": 2 * ROWS * 256 * 256 / per / 1e9}
    res["tile_gemm_ms"] = times
    print(json.dumps({"trial": res, "card": torch.cuda.get_device_name(0)}), flush=True)


def run_e2e_draws(label, draws):
    import copy
    import importlib.util
    import math
    import tempfile

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    mods = {}
    for name in ("chip_smoke", "e2e_port"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, name + ".py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    S, E = mods["chip_smoke"], mods["e2e_port"]
    from copenerf_torch.ops.kernels import rendercore as RC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "e2e")
    with S.launch_rows(S.kernel_counters()) as rows:
        E.run_torch(root, 0, "cuda", verbose=False)
    by_n = rows["rendercore_bwd"]
    n = max(by_n, key=lambda k: by_n[k][0])
    x = by_n[n][1]
    d = S.sample_rows(n, seed=n + 13)[1]
    _, _, _, nets = S.full_width_nets(
        0, cfg_path=os.path.join(root, "cfg_port_cuda_out.yaml"))
    sdf, col = nets["sdf"], nets["color"]
    sdf64, col64 = copy.deepcopy(sdf).double(), copy.deepcopy(col).double()
    params = [*sdf.parameters(), *col.parameters()]
    params64 = [*sdf64.parameters(), *col64.parameters()]
    smooth = (RC.color_relu_margin(sdf64, col64, x.double(), d.double())
              >= S.KINK_MARGIN).float()[:, None]

    def rel(a, b):
        b = b.float()
        return (a - b).norm().item() / b.norm().item()

    out = []
    for cot_seed in [n] + list(range(1, draws)):
        g = torch.Generator(device="cuda").manual_seed(cot_seed)
        full = [torch.randn((n, w), generator=g, device="cuda") for w in (1, 4, 3)]
        full[2] = full[2] * smooth
        res = {"cot_seed": cot_seed}
        for chan, on in (("sbar", (1, 0, 0)), ("gbar", (0, 1, 0)), ("cbar", (0, 0, 1))):
            cots = [c * m for c, m in zip(full, on)]
            got = S._vjp(lambda a, b: RC.rendercore_fwd(sdf, col, a, b), [x, d],
                         params, cots)
            ref = S._vjp(lambda a, b: RC.rendercore_fwd_plain(sdf, col, a, b),
                         [x, d], params, cots)
            r64 = S._vjp(lambda a, b: RC.rendercore_fwd_plain(sdf64, col64, a, b),
                         [x.double(), d.double()], params64,
                         [c.double() for c in cots])
            worst, logs = 0.0, []
            for a, b, c in zip(got, ref, r64):
                if c.norm().item() == 0:
                    continue
                ka, pb = rel(a, c), rel(b, c)
                worst = max(worst, ka / max(S.GRAD_TOL["factor_of_plain"] * pb,
                                            S.GRAD_TOL["floor"]))
                logs.append(math.log(max(ka, 1e-12) / max(pb, 1e-12)))
            res[chan] = {"worst_over_bound": worst,
                         "geo_kernel_over_plain": math.exp(sum(logs) / len(logs))}
        out.append(res)
    print(json.dumps({"label": label, "e2e_k1_bwd_draws": out, "rows": n,
                      "worst_over_bound": max(r[c]["worst_over_bound"]
                                              for r in out
                                              for c in ("sbar", "gbar", "cbar"))}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--trial", action="store_true")
    ap.add_argument("--e2e-draws", type=int, default=0)
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py needs a CUDA card")
    print(smi(), flush=True)
    if a.trial:
        run_trial()
    elif a.e2e_draws:
        run_e2e_draws(a.label, a.e2e_draws)
    else:
        run_times(a.label, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
