#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``copenerf_torch``) on one card.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, each printed on its own line, any failure exits non-zero:

1. device   card name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build    nvcc builds every kernel in ``copenerf_torch/csrc`` (one process
            per source, in parallel); prints the build time and ptxas usage.
3. kernels  each kernel against its plain PyTorch version on the card at the
            main path's widths (the full-width SDF + color net of
            configs/default.yaml, geometric init perturbed by ``perturb_`` so
            that the PE columns are not zero and the head's columns differ)
            and at a ragged row count; then CUDA-event times at the render
            chunk's shapes beside the plain version and the bound from FLOP
            and bytes counted from the shapes.
4. main     ``ImageRenderer.render_image`` renders 3 views (the requests) of
            the full-width model (plain geometric init: the centre ray must
            meet the init sphere) at 180x320, chunk 32768, with poses from
            the motion chain and the pose retriever; launch counters are
            zeroed just before and read just after (4 value sweeps + 1
            render-core launch per chunk).
5. card-cpu the same 1024 rays through ``render()`` on the card (kernels)
            and on the CPU (plain versions), with the main path's nets and
            with the perturbed ones, compared with stated tolerances.
6. the ``{"kernels": [...]}`` line, then the contract line
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package.
"""

import copy
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
CHUNK = 32768
VIEWS = 3
RES = (180, 320)
N_FRAMES = 31           # frames of the motion chain; views are 14, 15, 16
DEVICE = "cuda"


def fail(msg):
    raise RuntimeError(f"FAIL: {msg}")


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------------------
# Work counted from the shapes
# ---------------------------------------------------------------------------

def sdf_hidden_macs(scfg):
    from copenerf_torch.models.fields import idr_layer_dims

    n_lin = len(scfg.dims) - 1
    return sum(a * b for a, b in (idr_layer_dims(scfg, l)
                                  for l in range(n_lin - 1)))


def weight_bytes(*nets):
    return 4 * sum(p.numel() for net in nets for p in net.parameters())


def k2_work(scfg, n, sdf_net):
    """(FLOP, bytes) of the value sweep on n rows: hidden layers + column 0
    of the head; x (16 B) in and the value (4 B) out per row, weights once."""
    macs = sdf_hidden_macs(scfg) + scfg.d_hidden
    return 2 * macs * n, 20 * n + weight_bytes(sdf_net)


def k1_work(scfg, ccfg, n, sdf_net, color_net):
    """(FLOP, bytes) of the render-core forward on n rows: SDF forward with
    the full head, the reverse sweep (hidden layers + J_pe^T), the color MLP;
    x, dirs in (28 B) and sdf, grad, color out (32 B) per row."""
    fwd = sdf_hidden_macs(scfg) + scfg.d_hidden * scfg.d_out
    sweep = sdf_hidden_macs(scfg) + scfg.dims[0] * scfg.d_in
    dims = ccfg.dims
    color = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    macs = fwd + sweep + color
    return 2 * macs * n, 60 * n + weight_bytes(sdf_net, color_net)


def bound_ms(flop, nbytes):
    t_ops, t_bytes = flop / F32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def smi_under_load(fn, ms_each):
    """SM clock and power draw read by nvidia-smi while ~1.5 s of ``fn``
    launches run (a card below its power limit clocks down under load)."""
    import torch

    for _ in range(max(2, int(1500 / ms_each))):
        fn()
    time.sleep(0.7)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return smi.stdout.strip()


def cuda_ms(fn, reps):
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


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi_line,
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi_line


def phase_build():
    from copenerf_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    usage = [ln.strip() for ln in build.build_log().splitlines()
             if re.search(r"Used \d+ registers|spill", ln)]
    log("build", seconds=round(time.perf_counter() - t0, 3),
        cached=build.BUILD_STATS["cached"], ptxas=usage)


def full_width_nets(seed):
    """(cfg, field configs, geometric-init fields, the same fields perturbed
    for the checks)."""
    import torch
    from copenerf_torch.config import load_config
    from copenerf_torch.models import configs_from_cfg, init_all_fields
    from copenerf_torch.models.mlp import perturb_

    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    fcfg = configs_from_cfg(cfg)
    fields = init_all_fields(fcfg, torch.Generator().manual_seed(seed),
                             device=DEVICE)
    checked = perturb_(copy.deepcopy(fields),
                       torch.Generator().manual_seed(seed + 1))
    return cfg, fcfg, fields, checked


def sample_rows(n, seed):
    """Points as the render path sees them: inside the depth range around
    the init sphere, times in [-1, 1], unit view directions."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.empty((n, 4))
    x[:, :3] = (torch.rand((n, 3), generator=g) * 2 - 1) * 1.2
    x[:, 3] = torch.rand((n,), generator=g) * 2 - 1
    d = torch.randn((n, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return x.to(DEVICE), d.to(DEVICE)


def phase_kernels(fields):
    import torch
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import sdf_value as SV

    sdf_net, color_net = fields["sdf"], fields["color"]
    scfg, ccfg = sdf_net.cfg, color_net.cfg
    results = {}
    errs = {"sdf_value": 0.0, "rendercore_fwd": 0.0}
    for n in (262144, 1000):
        x, d = sample_rows(n, seed=n)
        v = SV.sdf_value_cuda(sdf_net, x)
        v_ref = SV.sdf_value_plain(sdf_net, x)
        torch.cuda.synchronize()
        e_v = (v - v_ref).abs().max().item()
        tol_v = 1e-4
        log("check", kernel="sdf_value", rows=n, max_abs_err=e_v, tol=tol_v)
        if not e_v <= tol_v:
            fail(f"sdf_value at {n} rows: max abs err {e_v} > {tol_v}")
        errs["sdf_value"] = max(errs["sdf_value"], e_v)
        got = RC.rendercore_fwd_cuda(sdf_net, color_net, x, d)
        ref = RC.rendercore_fwd_plain(sdf_net, color_net, x, d)
        torch.cuda.synchronize()
        worst = 0.0
        for name, g_, r_ in zip(("sdf", "grad", "color"), got, ref):
            scale = max(1.0, r_.abs().max().item()) if name == "grad" else 1.0
            e = (g_ - r_).abs().max().item()
            tol = 1e-4 * scale
            log("check", kernel="rendercore_fwd", output=name, rows=n,
                max_abs_err=e, tol=tol)
            if not e <= tol:
                fail(f"rendercore_fwd {name} at {n} rows: err {e} > {tol}")
            worst = max(worst, e)
        errs["rendercore_fwd"] = max(errs["rendercore_fwd"], worst)
        del got, ref

    # Times at the render chunk's shapes: 32768 rays x 64 / x 16 samples
    # for the sweep, x 128 for the render core.
    for n in (CHUNK * 64, CHUNK * 16):
        x, _ = sample_rows(n, seed=7)
        k_ms = cuda_ms(lambda: SV.sdf_value_cuda(sdf_net, x), reps=5)
        p_ms = cuda_ms(lambda: SV.sdf_value_plain(sdf_net, x), reps=3)
        b, by = bound_ms(*k2_work(scfg, n, sdf_net))
        load = smi_under_load(lambda: SV.sdf_value_cuda(sdf_net, x), k_ms)
        log("time", kernel="sdf_value", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
            bound_ms=b, bound_by=by, sm_clock_power_under_kernel=load)
        results.setdefault("sdf_value", []).append(
            dict(rows=n, ms=k_ms, plain_ms=p_ms, bound_ms=b, bound_by=by))
        del x
    n = CHUNK * 128
    x, d = sample_rows(n, seed=8)
    k_ms = cuda_ms(lambda: RC.rendercore_fwd_cuda(sdf_net, color_net, x, d),
                   reps=3)
    # The plain version's autograd graph at 4.2M rows would not fit the
    # card's memory: time it over the same rows in 8 slices.
    sl = n // 8

    def plain_slices():
        for i in range(0, n, sl):
            RC.rendercore_fwd_plain(sdf_net, color_net, x[i:i + sl],
                                    d[i:i + sl])
    p_ms = cuda_ms(plain_slices, reps=1)
    b, by = bound_ms(*k1_work(scfg, ccfg, n, sdf_net, color_net))
    load = smi_under_load(
        lambda: RC.rendercore_fwd_cuda(sdf_net, color_net, x, d), k_ms)
    log("time", kernel="rendercore_fwd", rows=n, kernel_ms=k_ms,
        plain_ms=p_ms, plain_note="8 slices of 524288 rows", bound_ms=b,
        bound_by=by, sm_clock_power_under_kernel=load)
    results["rendercore_fwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=b, bound_by=by)]
    del x, d
    torch.cuda.empty_cache()
    for k in results:
        results[k] = {"max_abs_err": errs[k], "times": results[k]}
    return results


def camera(h, w):
    """The reference's NDC-style K for a 60-degree horizontal field of view."""
    import numpy as np

    f = 0.5 * w / np.tan(np.deg2rad(30.0))
    return np.array([[2 * f / w, 0, 0, 0], [0, -2 * f / h, 0, 0],
                     [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)


def view_poses(fields, seed):
    """World->camera maps of the views: frames 14..16 of a 31-frame motion
    chain, re-anchored on the middle frame, placed 2.5 units from the init
    sphere (camera on +z looking down -z), with a small pose-retriever
    correction on top."""
    import torch
    from copenerf_torch.poses.lie import se3_inverse
    from copenerf_torch.poses.motion import full_video_w2c, w2c_from_anchor
    from copenerf_torch.poses.retriever import (pose_retriever_all,
                                                pose_retriever_init)

    frames = list(range(N_FRAMES // 2 - 1, N_FRAMES // 2 - 1 + VIEWS))
    with torch.no_grad():
        w2c_all = full_video_w2c(fields["motion"], N_FRAMES, 10)
        rel = w2c_from_anchor(w2c_all, frames[1])[frames]
        base = torch.eye(4, device=DEVICE)
        base[2, 3] = 2.5
        init_c2w = base[None] @ se3_inverse(rel)
        params, init_c2w = pose_retriever_init(VIEWS, init_c2w, device=DEVICE)
        g = torch.Generator().manual_seed(seed)
        params["r"] += (torch.randn((VIEWS, 3), generator=g) * 1e-2).to(DEVICE)
        params["t"] += (torch.randn((VIEWS, 3), generator=g) * 1e-2).to(DEVICE)
        w2c = se3_inverse(pose_retriever_all(params, init_c2w))
    return frames, w2c.cpu().numpy()


def time_of(idx):
    return idx / (N_FRAMES - 1) * 2.0 - 1.0


def phase_main(cfg, fields, counters):
    import numpy as np
    import torch
    from copenerf_torch.evaluation.render import ImageRenderer
    from copenerf_torch.ops.renderer import RendererConfig

    rcfg = RendererConfig.from_cfg(cfg)
    renderer = ImageRenderer(rcfg, chunk=CHUNK, device=DEVICE)
    h, w = RES
    K = camera(h, w)
    frames, w2c = view_poses(fields, seed=3)
    depth_range = cfg["rendering"]["depth_range"]
    eye = np.eye(4, dtype=np.float32)

    def one(i):
        return renderer.render_image(fields, K, w2c[i], eye,
                                     time_of(frames[i]), RES, depth_range,
                                     1.0)

    one(0)                                   # warm-up (not counted)
    for c in counters:
        c.launches = 0
    view_ms = []
    outs = []
    for i in range(VIEWS):
        t0 = time.perf_counter()
        outs.append(one(i))
        view_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {c.name: c.launches for c in counters}
    n_chunks = VIEWS * -(-(h * w) // CHUNK)
    for i, res in enumerate(outs):
        for k, v in res.items():
            if not np.all(np.isfinite(v)):
                fail(f"view {i}: non-finite {k}")
        if res["color"].shape != (h, w, 3) or res["depth"].shape != (h, w):
            fail(f"view {i}: wrong output shapes")
        center = float(res["depth"][h // 2, w // 2])
        log("view", view=i, frame=frames[i], ms=view_ms[i],
            rays_per_s=h * w / (view_ms[i] / 1e3), depth_center=center)
        # The centre ray meets the init sphere (radius 0.5, 2.5 away).
        if not 1.5 < center < 2.5:
            fail(f"view {i}: centre depth {center} misses the init sphere")
    want = {"sdf_value": 4 * n_chunks, "rendercore_fwd": n_chunks}
    log("main", views=VIEWS, resolution=list(RES), chunk=CHUNK,
        chunks=n_chunks, launches=launches, expected=want,
        mean_view_ms=sum(view_ms) / VIEWS)
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    return launches, (K, w2c[0], time_of(frames[0]), depth_range)


def render_card_and_cpu(cfg, fields, view):
    """Per-ray outputs of the same 1024 rays through ``render()`` on the
    card (kernels) and on the CPU (plain versions), and both times."""
    import torch
    from copenerf_torch.ops.rays import rays_from_pixels
    from copenerf_torch.ops.renderer import RendererConfig, render

    K, w2c, t, depth_range = view
    rcfg = RendererConfig.from_cfg(cfg)
    h, w = RES
    # 1024 pixels: rows 74..105 (32) x columns 144..175 (32) across the sphere.
    rows = torch.arange(74, 106).repeat_interleave(32)
    cols = torch.arange(144, 176).repeat(32)
    pixels = torch.stack([2.0 * cols / (w - 1.0) - 1.0,
                          2.0 * rows / (h - 1.0) - 1.0], -1).float()
    fields_cpu = copy.deepcopy(fields).cpu()
    out = {}
    for dev, f in ((DEVICE, fields), ("cpu", fields_cpu)):
        mats = [torch.as_tensor(m, device=dev).float()
                for m in (K, w2c, torch.eye(4).numpy())]
        with torch.no_grad():
            ro, rd, rn = rays_from_pixels(pixels.to(dev), *mats)
            n = ro.shape[0]
            near = torch.full((n, 1), float(depth_range[0]), device=dev)
            far = torch.full((n, 1), float(depth_range[1]), device=dev)
            t0 = time.perf_counter()
            res = render(f, ro, rd, rn, t, near, far, rcfg=rcfg,
                         cos_anneal_ratio=1.0, train=False)
            normal = torch.sum(res["normals"] * res["weights"][..., None], 1)
            out[dev] = {"color": res["color_fine"].cpu().reshape(n, -1),
                        "depth": res["depth_pred"].cpu().reshape(n, -1),
                        "normal": normal.cpu().reshape(n, -1)}
            if dev == "cuda":
                torch.cuda.synchronize()
            out[dev]["ms"] = 1e3 * (time.perf_counter() - t0)
    return out[DEVICE], out["cpu"]


def phase_card_vs_cpu(cfg, fields, checked, view):
    """Card against CPU on the main path's nets (every ray within 2e-3) and
    on the perturbed nets of the kernel checks. On that rougher field the
    importance chain (fixed inv_s up to 512, a discrete resampling) turns
    last-bit SDF differences into a moved sample on a few rays, and the
    plain versions on the card show the same tail against the CPU as the
    kernels do; so there the median ray must agree within 1e-4 (a kernel
    fault moves every ray) and the 99th percentile within 2e-3."""
    for nets, f, tol in (("main", fields, {"max": 2e-3}),
                         ("perturbed", checked, {"median": 1e-4,
                                                 "p99": 2e-3})):
        card, cpu = render_card_and_cpu(cfg, f, view)
        errs = {}
        for k in ("color", "depth", "normal"):
            e = (card[k] - cpu[k]).abs().amax(-1)
            errs[k] = {"max": e.max().item(), "median": e.median().item(),
                       "p99": e.quantile(0.99).item()}
        log("card_vs_cpu", nets=nets, rays=1024, errors=errs, tolerances=tol,
            card_ms=card["ms"], cpu_ms=cpu["ms"])
        for k, e in errs.items():
            for stat, lim in tol.items():
                if not e[stat] <= lim:
                    fail(f"card vs cpu ({nets} nets) {k}: {stat} abs err "
                         f"{e[stat]} > {lim}")


KERNELS = {
    "sdf_value": dict(source="copenerf_torch/csrc/sdf_value.cu",
                      replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:450"),
    "rendercore_fwd": dict(
        source="copenerf_torch/csrc/rendercore_fwd.cu",
        replaces="copenerf_tpu/ops/pallas/rendercore_kernels.py:326"),
}


def print_contract_line():
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    import torch

    # The port must be beside this script: fail before printing anything.
    sys.path.insert(0, REPO)
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import sdf_value as SV

    phase_device()
    phase_build()
    cfg, _, fields, checked = full_width_nets(seed=0)
    with torch.no_grad():
        kres = phase_kernels(checked)
    counters = [SV.COUNTER, RC.COUNTER]
    launches, view = phase_main(cfg, fields, counters)
    phase_card_vs_cpu(cfg, fields, checked, view)

    rows = []
    for name, meta in KERNELS.items():
        # The time line is the main path's largest shape for each kernel.
        t = kres[name]["times"][0]
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": kres[name]["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "rows": t["rows"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print_contract_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
