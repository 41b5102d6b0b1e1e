#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``copenerf_torch``) on one card.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, each printed on its own line, any failure exits non-zero:

1. device   card name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build    nvcc builds every kernel in ``copenerf_torch/csrc`` (one process
            per source, in parallel); prints the build time and ptxas usage,
            then (``registers``) the registers and spill bytes of the
            tensor-core kernels: K1 and K6 (3xTF32 on ``mma.sync``,
            ``csrc/mma_tile.cuh``), K2-K5 and K7 (3xTF32 on ``wgmma``,
            ``csrc/wgmma_tile.cuh``) and the weight-gradient reduction
            (``wgmma``, ``csrc/wgrad.cu``), and any ptxas line about the
            wgmma pipeline (``wgmma_warnings``).
3. kernels  each forward kernel against its plain PyTorch version on the card
            at the main path's widths (the full-width SDF + color net of
            configs/default.yaml, geometric init perturbed by ``perturb_`` so
            that the PE columns are not zero and the head's columns differ)
            and at a ragged row count; then CUDA-event times at the render
            chunk's shapes beside the plain version and the bound from FLOP
            and bytes counted from the shapes and ``tc_bound_ms``, the same
            work in 3xTF32 on the tensor cores.
4. train_kernels  K1-bwd and K3 (fwd, bwd) through their autograd.Functions
            against autograd of the plain versions on the same perturbed nets,
            at 262,144 and 1,000 rows: K1 for sbar, gbar, cbar alone and all
            three (no color cotangent on rows with a color ReLU within
            KINK_MARGIN of its kink), every input and parameter gradient;
            then CUDA-event times at the train step's shapes (131,072 rows;
            the forward kernels too, for the step's kernels / glue split);
            K1-bwd's and K3-bwd's lines split them into the row kernel and
            the weight-gradient reduction (``torch.profiler`` device times)
            and time ``torch.mm`` of the reduction's jobs as a yardstick
            (``reduction_mm_ms``, as every backward's line does);
            the value pack a step builds once for K2 and K3 is timed too.
5. composed_kernels  K4 (SDF outgrad) and K5 (color MLP), the kernels of
            the composed field path (``use_negative_ray_vector: true``), on
            the perturbed full-width nets of that config: the forward
            kernels against their plain versions (K5 on dirs and grad
            negated, the feature a slice of the head), the backward kernels
            against autograd of the plain versions and an f64 evaluation,
            at 262,144 and 1,000 rows (K4 for the head's column 0, its
            feature columns, gbar alone and all; K5 with the KINK_MARGIN
            rule); then CUDA-event times at the render chunk's shapes
            (4,194,304 rows) and the train step's (131,072 rows), K4-bwd's
            and K5-bwd's split into the row kernel and the reduction, each
            reduction beside ``torch.mm`` of it as a yardstick.
6. main     ``ImageRenderer.render_image`` renders 3 views (the requests) of
            the full-width model (plain geometric init: the centre ray must
            meet the init sphere) at 180x320, chunk 32768, with poses from
            the motion chain and the pose retriever; launch counters are
            zeroed just before and read just after (4 value sweeps + 1
            render-core launch per chunk, no K4 or K5).
7. card-cpu the same 1024 rays through ``render()`` on the card (kernels) and
            on the CPU (plain versions), with the main path's nets and with
            the perturbed ones, compared with stated tolerances.
8. train    30 stage-1 steps (``training/step.py``) of the full-width model on
            a synthetic 31-frame 540x960 video, 1024 rays as 64 4x4 patches,
            64 + 64 samples, flow-rgb and sdf-consistency on, motion trained;
            one fixed batch (patches drawn once on the card); loss and ms per
            step; launch counters zeroed just before and read just after (4
            K2, 1 K1-fwd, 1 K1-bwd, 1 K3-fwd, 1 K3-bwd per step); the mean
            step split into the kernels' times alone and the rest (glue).
9. train_card_vs_cpu  one step with injected ray_idx (64 rays) and t_rand on
            the card and on the CPU, main-path and perturbed nets: every
            metric and both optimizer groups' gradients.
10. train_stage2_card_vs_cpu  the same on a stage-2 step (StepStatic
            stage1=False, train_motion=False: no flow-rgb or sdf-consistency
            term, so no K3), the query at the world camera's time through a
            world_mat rotated 0.1 rad besides its shift, stage-2 loss
            weights; the same bounds.
11. eval_pose_card_vs_cpu  one test-time pose step
            (``evaluator.pose_loss``, the fields frozen) on the card and on
            the CPU: 64 rays of the train batch's image, the pose a rotated
            camera plus a non-zero (r, t); main-path and perturbed nets; the
            loss, l2 and r / t gradients within the stage-2 step's bounds.
12. composed_main  one view as in ``main`` under the negative-ray config:
            4 K2 + 1 K4-fwd + 1 K5-fwd per chunk, no K1.
13. composed_train  10 steps as in ``train`` under that config: 4 K2, 1
            K4-fwd, 1 K4-bwd, 1 K5-fwd, 1 K5-bwd, 1 K3-fwd, 1 K3-bwd per
            step, no K1; the loss finite, its last-3 mean below its first-3.
14. composed_card_vs_cpu  ``train_card_vs_cpu`` under that config.
15. fold_kernels  K6 (K1 with the K3 query at y folded into its launches,
            the JAX package's COPENERF_FOLD_CONS=1) on the perturbed idr
            nets: K6-fwd against ``rendercore_cons_plain``, K6-bwd against
            autograd of it and f64 for sbar, gbar, cbar (KINK_MARGIN), swbar
            alone and all four, at 262,144 and 1,000 rows; times at 131,072
            rows beside K1 + K3 timed in turns in the same call.
16. fold_train  10 steps as in ``composed_train`` with COPENERF_FOLD_CONS=1
            set in this process (restored after): 4 K2 + 1 K6-fwd + 1 K6-bwd
            per step, no K1 or K3.
17. fold_card_vs_cpu  ``train_card_vs_cpu`` with the fold and the
            sdf-consistency pose gradient on (K6's y_bar reaches the motion
            net).
18. out_kernels  ``fields.sdf_output`` driven once (counters zeroed: 1 K7-fwd
            + 1 K7-bwd), then K7 against ``sdf_apply`` and f64 (column 0,
            the feature columns, all) at 262,144 and 1,000 rows; times at
            131,072 rows, K7-bwd's split into its row kernel and the
            reduction beside ``torch.mm`` of the reduction.
19. metrics_f32  SSIM and LPIPS (random He-scaled VGG16 weights) of a
            270x480 pair on the card with cuDNN's TF32 switched on (PyTorch's
            default) for the phase, against float64 on the CPU: SSIM within
            1e-6, LPIPS within 1e-5 relative (the metrics force f32
            themselves); readings of the same metrics unguarded in TF32 and
            of an SSIM through cuDNN; times of PSNR, SSIM, LPIPS.
20. trainer  ``Trainer(cfg).train(max_epochs=2)`` of the port's
            ``training/trainer.py`` on a Co3D-convention synthetic scene
            written by the port's ``data/synthetic.py`` (12 frames at
            270x480, 11 train views), the full-width nets of
            configs/default.yaml, 1024 rays as 64 4x4 patches, 64 + 64
            samples (every override of defaults.yaml printed as a cut); a
            second ``Trainer`` resumes from the epoch-1 checkpoint and trains
            one more epoch. Launch counters zeroed before and read after (per
            step 4 K2 + 1 K1-fwd + 1 K1-bwd + 1 K3-fwd + 1 K3-bwd, per
            visualization chunk 4 K2 + 1 K1-fwd, no K4-K7); finite epoch
            losses, the last epoch's mean below the first's; the resumed state
            equal to the saved one; the checkpoint's flat Adam moments as long
            as the JAX layout's; finite ATE / RPE; 2 train views rendered.
            Prints the Trainer's ms per iteration (host clock, a device sync at
            the loop's ends) beside the train phase's bare step, the
            device-busy share of a 5-iteration ``torch.profiler`` window and
            the peak device memory.
21. trainer_stage2  ``Trainer(cfg).train(max_epochs=2)`` across the
            stage-1 -> stage-2 transition on the trainer phase's scene and
            nets (``start_query_world_epoch`` 1, ``pose_refine_epochs`` 60,
            the refinement started from the motion field's poses): the
            transition renders the 11 train views (4 chunks each), refines
            the poses and writes ``refine_pose.npz``; a second ``Trainer``
            resumes from the transition epoch's checkpoint on the refined
            poses for a third epoch. Launch counters zeroed before and read
            after (per stage-1 step as in ``trainer``, per stage-2 step 4 K2
            + 1 K1-fwd + 1 K1-bwd, per render chunk 4 K2 + 1 K1-fwd); gates:
            finite epoch losses, no fallback, the refinement's loss falling,
            the poses' shape and world view, the resumed table equal, the
            motion Adam count frozen, 5 files a stage-1 visualization and 4 a
            stage-2 one. Prints the transition's split (render, refinement),
            the refinement's ms an epoch with and without the host pose
            metrics, stage 2's ms an iteration with and without
            visualizations, its busy share and the peak memory.
22. evaluator  ``Evaluator(cfg).eval()`` of the port's
            ``evaluation/evaluator.py`` on ``trainer_stage2``'s run (1 test
            view, frame 4; ``eval_pose_epoch`` 300 pose steps of 1,024 rays;
            the view rendered in 4 chunks; PSNR / SSIM / LPIPS, 7 depth
            metrics, ATE / RPE, ``results.txt`` and six extraction folders).
            Launch counters zeroed before and read after (per pose step 4 K2
            + 1 K1-fwd + 1 K1-bwd, per render chunk 4 K2 + 1 K1-fwd, no
            K3-K7); finite metrics, LPIPS NaN with its warning without a
            weight pack, one file per folder, the field weights unchanged; a
            second ``Evaluator`` reuses the pose cache (no K1-bwd) with the
            same metrics. Prints pose-step ms, render ms a view, metric ms,
            peak memory and the l2 of the first and last epoch.
23. pose_refine_shape  ``run_pose_refinement`` at configs/Co3D/bench.yaml's
            stage-2 size (712x1266, 34 synthetic views, 33 pairs in batches
            of 16, 16, 1): ms an epoch without and with the host pose
            metrics, the device's busy ms an epoch, peak memory, and the
            default 2,000 epochs projected. No gate on speed.
24. the ``{"kernels": [...]}`` line (launches per path: render, train,
   render_composed, train_composed, train_fold, sdf_output, trainer,
   trainer_stage2, evaluate), then the contract line ``{"ok": true, "device":
   {...}}`` last.

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
TC_TF32_PEAK = 495e12   # H100 SXM dense TF32 FLOP/s on the tensor cores
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
CHUNK = 32768
VIEWS = 3
RES = (180, 320)
N_FRAMES = 31           # frames of the motion chain; views are 14, 15, 16
DEVICE = "cuda"
TRAIN_RES = (540, 960)  # the Tanks resolution of the reference protocol
TRAIN_STEPS = 30
STEP_ROWS = 1024 * 128  # rows of the field queries in one train step
CAM_DIST = 1.0          # train camera to the init sphere (radius 0.5): it fills the view
CHECK_ROWS = (262144, 1000)
TRAINER_RES = (270, 480)  # the trainer phase's scene: 12 Co3D-style frames
TRAINER_FRAMES = 12
STEP_MEAN_MS = {}         # each train phase's bare step mean, by phase


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


def color_macs(ccfg):
    dims = ccfg.dims
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def k3_bwd_work(scfg, n, sdf_net):
    """(FLOP, bytes) of K3-bwd on n rows: the forward recomputed, the
    down-sweep and the weight reduction, each over the hidden layers and the
    head's column 0; x and obar in (20 B), x_bar out (16 B) per row, the
    weights read and their gradients written once."""
    macs = 3 * (sdf_hidden_macs(scfg) + scfg.d_hidden)
    return 2 * macs * n, 36 * n + 2 * weight_bytes(sdf_net)


def reduction_mm_ms(kernel, scfg, ccfg, n):
    """CUDA-event ms of a backward kernel's weight reduction done by
    torch.mm, one product a job on random rows of the staged widths
    (``kernel_times.reduction_pairs``). A yardstick, timed only."""
    import torch
    from kernel_times import reduction_pairs

    pairs = reduction_pairs(kernel, scfg, ccfg, n,
                            torch.Generator(device=DEVICE).manual_seed(21))
    ms = cuda_ms(lambda: [torch.mm(z.t(), t) for z, t in pairs], reps=5)
    del pairs
    torch.cuda.empty_cache()
    return ms


MM_NOTE = ("torch.mm of each reduction job's staged pairs (a job's pairs as one "
           "product over their rows): the reduction's yardstick, not called by the port")


def k1_bwd_work(scfg, ccfg, n, sdf_net, color_net):
    """(FLOP, bytes) of K1-bwd on n rows: the SDF forward and feature
    recomputed, the gradient sweep, the color MLP forward and backward, the
    channel-B up-sweep, the down-sweep (head, channel A over every layer,
    channel B down to layer 1) and the weight reductions (two products per
    SDF hidden layer, the head, its row-0 extra, the color layers); x, dirs,
    sbar, gbar, cbar in (60 B), x_bar, dirs_bar out (28 B) per row, the
    weights read and their gradients written once."""
    from copenerf_torch.models.fields import idr_layer_dims

    H = sdf_hidden_macs(scfg)
    L0 = scfg.dims[0] * idr_layer_dims(scfg, 0)[1]
    F = scfg.d_hidden * (scfg.d_out - 1)
    C = color_macs(ccfg)
    hd = scfg.d_hidden
    macs = ((H + F) + (H + C) + (C + H) + (F + hd + H + (H - L0))
            + (2 * H + hd * scfg.d_out + hd + C))
    return 2 * macs * n, 88 * n + 2 * weight_bytes(sdf_net, color_net)


def k4_fwd_work(scfg, n, sdf_net):
    """(FLOP, bytes) of the outgrad forward on n rows: the SDF forward with
    the full head and the reverse sweep (hidden layers + J_pe^T); x in
    (16 B), the d_out-wide head and grad out per row."""
    macs = (2 * sdf_hidden_macs(scfg) + scfg.d_hidden * scfg.d_out
            + scfg.dims[0] * scfg.d_in)
    return 2 * macs * n, (32 + 4 * scfg.d_out) * n + weight_bytes(sdf_net)


def k4_bwd_work(scfg, n, sdf_net):
    """(FLOP, bytes) of the outgrad backward on n rows: the forward
    recomputed, the sweep down to u_0, the channel-B up-sweep, the head, the
    down-sweep (channel A over every layer, channel B down to layer 1) and
    the weight reductions (two products per hidden layer, the head, its
    row-0 extra); x, obar, gbar in, x_bar out per row, the weights read and
    their gradients written once."""
    from copenerf_torch.models.fields import idr_layer_dims

    H = sdf_hidden_macs(scfg)
    L0 = scfg.dims[0] * idr_layer_dims(scfg, 0)[1]
    hd = scfg.d_hidden
    macs = (H + (H - L0) + H + (hd * (scfg.d_out - 1) + hd) + H + (H - L0)
            + (2 * H + hd * scfg.d_out + hd))
    return 2 * macs * n, (48 + 4 * scfg.d_out) * n + 2 * weight_bytes(sdf_net)


def k5_fwd_work(ccfg, n, color_net):
    """(FLOP, bytes) of the color forward on n rows: the MLP; x, dirs, grad
    and the feature in, color out per row."""
    return (2 * color_macs(ccfg) * n,
            (56 + 4 * ccfg.d_feature) * n + weight_bytes(color_net))


def k5_bwd_work(ccfg, n, color_net):
    """(FLOP, bytes) of the color backward on n rows: the forward
    recomputed, the backward to every input and the weight reductions, each
    the MLP's size; the forward's inputs and cbar in, the cotangents of x,
    dirs, grad and the feature out per row, the weights read and their
    gradients written once."""
    return (6 * color_macs(ccfg) * n,
            (112 + 8 * ccfg.d_feature) * n + 2 * weight_bytes(color_net))


def k6_fwd_work(scfg, ccfg, n, sdf_net, color_net):
    """(FLOP, bytes) of the folded render-core forward on n rows: K1-fwd's
    work and the value sweep at y; y in and sdf_w out (20 B) per row beside
    K1-fwd's rows, the weights once."""
    flop1, _ = k1_work(scfg, ccfg, n, sdf_net, color_net)
    flop2, _ = k2_work(scfg, n, sdf_net)
    return flop1 + flop2, 80 * n + weight_bytes(sdf_net, color_net)


def k6_bwd_work(scfg, ccfg, n, sdf_net, color_net):
    """(FLOP, bytes) of the folded backward on n rows: K1-bwd's work and
    K3-bwd's at y; y and swbar in, y_bar out (36 B) per row beside K1-bwd's
    rows, the weights read and their gradients written once."""
    flop1, _ = k1_bwd_work(scfg, ccfg, n, sdf_net, color_net)
    flop3, _ = k3_bwd_work(scfg, n, sdf_net)
    return flop1 + flop3, 124 * n + 2 * weight_bytes(sdf_net, color_net)


def k7_fwd_work(scfg, n, sdf_net):
    """(FLOP, bytes) of the SDF output forward on n rows: the hidden layers
    and the full head; x in (16 B), the d_out-wide head out per row."""
    head = sdf_hidden_macs(scfg) + scfg.d_hidden * scfg.d_out
    return 2 * head * n, (16 + 4 * scfg.d_out) * n + weight_bytes(sdf_net)


def k7_bwd_work(scfg, n, sdf_net):
    """(FLOP, bytes) of its first-order backward on n rows: the forward
    recomputed, the down-sweep to x and the weight reductions, each the
    forward's products; x and obar in, x_bar out per row, the weights read
    and their gradients written once."""
    head = sdf_hidden_macs(scfg) + scfg.d_hidden * scfg.d_out
    return 6 * head * n, (32 + 4 * scfg.d_out) * n + 2 * weight_bytes(sdf_net)


def bound_ms(flop, nbytes):
    t_ops, t_bytes = flop / F32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tc_bound_ms(flop, nbytes):
    """The bound of the same work in 3xTF32 on the tensor cores: three TF32
    products per f32 product."""
    return 1e3 * max(3 * flop / TC_TF32_PEAK, nbytes / HBM_RATE)


def bounds(flop, nbytes):
    """bound_ms, bound_by and tc_bound_ms of the same work, for a time line."""
    b, by = bound_ms(flop, nbytes)
    return dict(bound_ms=b, bound_by=by, tc_bound_ms=tc_bound_ms(flop, nbytes))


def split_ms(fn, reps, row_kernel):
    """(row kernel ms, reduction ms, every kernel's ms) of one call of a
    backward launcher, from torch.profiler's device times
    (``kernel_times.kernel_split``); "not measured" where it sees none."""
    from kernel_times import kernel_split

    split = kernel_split(fn, reps)
    if split is None:
        return "not measured", "not measured", "not measured"
    return (sum(v for k, v in split.items() if row_kernel in k),
            sum(v for k, v in split.items() if k.startswith("wgrad")), split)


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
    # "kernel<template bool args>: registers, spills" per compiled kernel.
    usage, name, nvcc_s = [], "?", {}
    for ln in build.build_log().splitlines():
        if ln.startswith("nvcc seconds "):
            src, sec = ln[len("nvcc seconds "):].split(": ")
            nvcc_s[src] = float(sec)
            continue
        m = re.search(r"Compiling entry function '.*?([a-z_]+_kernel)"
                      r"(I(?:L(?:b|i|N\w+?E)\d+E)+E)?", ln)
        if m:
            name = m.group(1) + ("<%s>" % ",".join(
                re.findall(r"L(?:b|i|N\w+?E)(\d+)E", m.group(2))) if m.group(2) else "")
        elif re.search(r"Used \d+ registers|spill", ln):
            usage.append(f"{name}: {ln.strip()}")
    log("build", seconds=round(time.perf_counter() - t0, 3),
        cached=build.BUILD_STATS["cached"], nvcc_seconds=nvcc_s, ptxas=usage)
    # The tensor-core kernels (K1-K6 and their reduction): registers and
    # spill bytes (stores, loads).
    from kernel_times import registers

    tc = {k: dict(zip(("registers", "spill_stores", "spill_loads"), v))
          for k, v in registers(build.build_log()).items()
          if k.startswith(("rendercore_", "wgrad_wg_", "sdf_value", "sdf_out",
                           "color_"))}
    log("registers", kernels=tc)
    # ptxas says when it serializes the wgmma pipeline (a performance loss).
    warn = [ln.strip() for ln in build.build_log().splitlines() if "wgmma" in ln]
    log("wgmma_warnings", lines=warn)


def full_width_nets(seed, negative_ray=False):
    """(cfg, field configs, geometric-init fields, the same fields perturbed
    for the checks); ``negative_ray`` sets the color net's
    ``use_negative_ray_vector`` (the composed path), with the same weights."""
    import torch
    from copenerf_torch.config import load_config
    from copenerf_torch.models import configs_from_cfg, init_all_fields
    from copenerf_torch.models.mlp import perturb_

    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    cfg["neus_rendering_network"]["use_negative_ray_vector"] = negative_ray
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
        errs["rendercore_fwd"] = max(errs["rendercore_fwd"], check_forward(
            "rendercore_fwd", ("sdf", "grad", "color"), got, ref, n))
        del got, ref

    # Times at the render chunk's shapes: 32768 rays x 64 / x 16 samples
    # for the sweep, x 128 for the render core.
    for n in (CHUNK * 64, CHUNK * 16):
        x, _ = sample_rows(n, seed=7)
        k_ms = cuda_ms(lambda: SV.sdf_value_cuda(sdf_net, x), reps=5)
        p_ms = cuda_ms(lambda: SV.sdf_value_plain(sdf_net, x), reps=3)
        bd = bounds(*k2_work(scfg, n, sdf_net))
        load = smi_under_load(lambda: SV.sdf_value_cuda(sdf_net, x), k_ms)
        log("time", kernel="sdf_value", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
            **bd, sm_clock_power_under_kernel=load)
        results.setdefault("sdf_value", []).append(
            dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd))
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
    work = k1_work(scfg, ccfg, n, sdf_net, color_net)
    b, by = bound_ms(*work)
    load = smi_under_load(
        lambda: RC.rendercore_fwd_cuda(sdf_net, color_net, x, d), k_ms)
    log("time", kernel="rendercore_fwd", rows=n, kernel_ms=k_ms,
        plain_ms=p_ms, plain_note="8 slices of 524288 rows", bound_ms=b,
        bound_by=by, tc_bound_ms=tc_bound_ms(*work),
        sm_clock_power_under_kernel=load)
    results["rendercore_fwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=b, bound_by=by,
                                      tc_bound_ms=tc_bound_ms(*work))]
    del x, d
    torch.cuda.empty_cache()
    for k in results:
        results[k] = {"max_abs_err": errs[k], "times": results[k]}
    return results


def rel_norm(a, b):
    """||a - b|| / ||b|| (0 when both are 0)."""
    nb = b.norm().item()
    nd = (a - b).norm().item()
    return nd / nb if nb > 0 else (0.0 if nd == 0 else float("inf"))


GRAD_TOL = {"factor_of_plain": 2.0, "floor": 1e-5}
# Rows where a color ReLU's f64 pre-activation lies within this of 0 get no
# color cotangent in the K1-bwd checks: f32 rounding moves those
# pre-activations by up to ~2e-6, and a ReLU that flips in one f32 version
# and not in the other moves its row's gradients by far more than rounding.
KINK_MARGIN = 2e-5


def check_grads(what, names, got, plain, ref64, scales=None):
    """Every gradient tensor of the kernel is held against an f64
    evaluation of the plain version: its error norm must be at most 2x that
    of the plain f32 version, or 1e-5 of the tensor's scale. The scale is
    the f64 tensor's norm, or ``scales`` (for all cotangents at once, the
    sum of the norms of each channel's gradient alone: an f32 sum is exact
    to the rounding of its terms, not of its result, and in the SDF head's
    g the channels' contributions cancel to a thirtieth of themselves).
    Returns the largest |kernel - plain f32|."""
    errs = []
    for i, (nm, a, b, c) in enumerate(zip(names, got, plain, ref64)):
        c = c.float()
        nc = c.norm().item()
        dk, dp = (a - c).norm().item(), (b - c).norm().item()
        scale = scales[i] if scales else nc
        errs.append((nm, rel_norm(a, c), rel_norm(b, c),
                     dk <= max(GRAD_TOL["factor_of_plain"] * dp,
                               GRAD_TOL["floor"] * scale)))
    bad = [e[:3] for e in errs if not e[3]]
    max_abs = max((a - b).abs().max().item() for a, b in zip(got, plain))
    log("check", **what, tensors=len(errs),
        worst_kernel_vs_f64=max(e[1] for e in errs),
        worst_plain_vs_f64=max(e[2] for e in errs), max_abs_err=max_abs,
        tolerances=GRAD_TOL)
    if bad:
        fail(f"{what}: {bad[:4]}")
    return max_abs


def _vjp(fn, inputs, params, cots):
    """Gradients of every input and parameter of ``fn(*inputs)`` for
    ``cots``; unreached ones as zeros."""
    import torch

    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    grads = torch.autograd.grad(fn(*ins), ins + params, cots, allow_unused=True)
    return [g if g is not None else torch.zeros_like(t)
            for g, t in zip(grads, ins + params)]


def _vjp_slices(fn, inputs, params, cots, sl):
    """``_vjp`` over row slices of ``sl`` rows: input gradients
    concatenated, parameter gradients summed (the plain version's
    double-backward graph of 262,144 full-width rows does not fit the
    card)."""
    import torch

    n = inputs[0].shape[0]
    acc = None
    for i in range(0, n, sl):
        g = _vjp(fn, [t[i:i + sl] for t in inputs], params,
                 [c[i:i + sl] for c in cots])
        if acc is None:
            acc = [[x] for x in g[:len(inputs)]] + list(g[len(inputs):])
        else:
            for k in range(len(inputs)):
                acc[k].append(g[k])
            for k in range(len(inputs), len(g)):
                acc[k] = acc[k] + g[k]
    return [torch.cat(a) for a in acc[:len(inputs)]] + acc[len(inputs):]


def phase_train_kernels(fields):
    """K1-bwd and K3 through their autograd.Functions against autograd of
    the plain versions (perturbed full-width nets), then times at the train
    step's shapes."""
    import torch
    from copenerf_torch.ops.kernels import pack
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import sdf_value as SV
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

    sdf_net, color_net = fields["sdf"], fields["color"]
    sdf64, color64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    scfg, ccfg = sdf_net.cfg, color_net.cfg
    params = [*sdf_net.parameters(), *color_net.parameters()]
    params64 = [*sdf64.parameters(), *color64.parameters()]
    names = (["x", "dirs"] + [f"sdf.{k}" for k, _ in sdf_net.named_parameters()]
             + [f"color.{k}" for k, _ in color_net.named_parameters()])
    sdf_params = list(sdf_net.parameters())
    errs = {"rendercore_bwd": 0.0, "sdf_value_diff_fwd": 0.0,
            "sdf_value_bwd": 0.0}
    for n in CHECK_ROWS:
        x, d = sample_rows(n, seed=n + 11)
        g = torch.Generator(device=DEVICE).manual_seed(n)
        full = [torch.randn((n, w), generator=g, device=DEVICE)
                for w in (1, 4, 3)]
        margin = RC.color_relu_margin(sdf64, color64, x.double(), d.double())
        smooth = margin >= KINK_MARGIN
        log("kinks", rows=n, margin=KINK_MARGIN,
            cbar_zeroed_share=1.0 - smooth.float().mean().item())
        full[2] = full[2] * smooth.float()[:, None]
        del margin
        e = check_channels(
            "rendercore_bwd", n, names,
            lambda a, b: RC.rendercore_fwd(sdf_net, color_net, a, b),
            lambda f64, a, b: RC.rendercore_fwd_plain(
                *((sdf64, color64) if f64 else (sdf_net, color_net)), a, b),
            [x, d], params, params64, full,
            [("sbar", (1, 0, 0)), ("gbar", (0, 1, 0)), ("cbar", (0, 0, 1)),
             ("all", (1, 1, 1))], 32768)
        errs["rendercore_bwd"] = max(errs["rendercore_bwd"], e)
        xk = x.clone().requires_grad_(True)
        v = SVD.sdf_value_diff(sdf_net, xk)
        with torch.no_grad():
            v_ref = SVD.sdf_value_diff_plain(sdf_net, x)
        e_v = (v.detach() - v_ref).abs().max().item()
        log("check", kernel="sdf_value_diff_fwd", rows=n, max_abs_err=e_v,
            tol=1e-4)
        if not e_v <= 1e-4:
            fail(f"sdf_value_diff_fwd at {n} rows: {e_v} > 1e-4")
        errs["sdf_value_diff_fwd"] = max(errs["sdf_value_diff_fwd"], e_v)
        obar = full[0][:, 0].contiguous()
        got = _vjp(lambda a: SVD.sdf_value_diff(sdf_net, a), [x], sdf_params,
                   [obar])
        ref = _vjp_slices(lambda a: SVD.sdf_value_diff_plain(sdf_net, a), [x],
                          sdf_params, [obar], 65536)
        ref64 = _vjp_slices(lambda a: SVD.sdf_value_diff_plain(sdf64, a),
                            [x.double()], list(sdf64.parameters()),
                            [obar.double()], 32768)
        e = check_grads(dict(kernel="sdf_value_bwd", rows=n),
                        ["x"] + [f"sdf.{k}" for k, _ in sdf_net.named_parameters()],
                        got, ref, ref64)
        errs["sdf_value_bwd"] = max(errs["sdf_value_bwd"], e)
        del x, d, got, ref, ref64, full
        torch.cuda.empty_cache()

    # Times at the train step's shapes: 1024 rays x 128 samples.
    n = STEP_ROWS
    x, d = sample_rows(n, seed=9)
    g = torch.Generator(device=DEVICE).manual_seed(9)
    cots = [torch.randn((n, w), generator=g, device=DEVICE) for w in (1, 4, 3)]
    results = {}
    with torch.no_grad():
        rc_pack = pack.pack_rendercore(sdf_net, color_net)
        v_pack = pack.pack_sdf_value_layers(pack.effective_layers(sdf_net))
    k_ms = cuda_ms(lambda: RC.rendercore_bwd_cuda(scfg, ccfg, rc_pack, x, d,
                                                  *cots), reps=3)
    # The plain backward: autograd.grad over a prebuilt double-backward
    # graph, in 4 slices of 32,768 rows (the whole graph does not fit).
    p_ms = 0.0
    for i in range(0, n, 32768):
        xs = x[i:i + 32768].clone().requires_grad_(True)
        ds = d[i:i + 32768].clone().requires_grad_(True)
        out = RC.rendercore_fwd_plain(sdf_net, color_net, xs, ds)
        cs = [c[i:i + 32768] for c in cots]
        p_ms += cuda_ms(lambda: torch.autograd.grad(out, [xs, ds] + params, cs,
                                                    retain_graph=True), reps=2)
        del out
    work = k1_bwd_work(scfg, ccfg, n, sdf_net, color_net)
    b, by = bound_ms(*work)
    load = smi_under_load(lambda: RC.rendercore_bwd_cuda(
        scfg, ccfg, rc_pack, x, d, *cots), k_ms)
    row_ms, red_ms, split = split_ms(lambda: RC.rendercore_bwd_cuda(
        scfg, ccfg, rc_pack, x, d, *cots), 3, "rendercore_bwd_kernel")
    log("time", kernel="rendercore_bwd", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
        plain_note="autograd.grad of the plain version, 4 slices of 32768 rows",
        bound_ms=b, bound_by=by, tc_bound_ms=tc_bound_ms(*work),
        row_kernel_ms=row_ms, reduction_ms=red_ms, kernel_split_ms=split,
        reduction_mm_ms=reduction_mm_ms("rendercore_bwd", scfg, ccfg, n),
        reduction_mm_note=MM_NOTE, sm_clock_power_under_kernel=load)
    results["rendercore_bwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=b, bound_by=by,
                                      tc_bound_ms=tc_bound_ms(*work))]
    torch.cuda.empty_cache()

    k_ms = cuda_ms(lambda: SVD.launch_value(scfg, v_pack, x, SVD.FWD_COUNTER),
                   reps=5)
    p_ms = cuda_ms(lambda: SVD.sdf_value_diff_plain(sdf_net, x), reps=3)
    bd = bounds(*k2_work(scfg, n, sdf_net))
    log("time", kernel="sdf_value_diff_fwd", rows=n, kernel_ms=k_ms,
        plain_ms=p_ms, plain_note="the plain forward under autograd", **bd)
    results["sdf_value_diff_fwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd)]
    obar = cots[0][:, 0].contiguous()
    k_ms = cuda_ms(lambda: SVD.sdf_value_bwd_cuda(scfg, v_pack, x, obar), reps=5)
    xs = x.clone().requires_grad_(True)
    out = SVD.sdf_value_diff_plain(sdf_net, xs)
    p_ms = cuda_ms(lambda: torch.autograd.grad(out, [xs] + sdf_params, obar,
                                               retain_graph=True), reps=3)
    del out
    bd = bounds(*k3_bwd_work(scfg, n, sdf_net))
    load = smi_under_load(lambda: SVD.sdf_value_bwd_cuda(scfg, v_pack, x, obar),
                          k_ms)
    row_ms, red_ms, split = split_ms(lambda: SVD.sdf_value_bwd_cuda(
        scfg, v_pack, x, obar), 3, "sdf_value_bwd_kernel")
    log("time", kernel="sdf_value_bwd", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
        plain_note="autograd.grad of the plain version", **bd,
        row_kernel_ms=row_ms, reduction_ms=red_ms, kernel_split_ms=split,
        reduction_mm_ms=reduction_mm_ms("sdf_value_bwd", scfg, ccfg, n),
        reduction_mm_note=MM_NOTE,
        sm_clock_power_under_kernel=load)
    results["sdf_value_bwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd)]

    # The forward kernels at the step's shapes too (K2 at 1024 x 64 and
    # 1024 x 16 rows, K1-fwd at 1024 x 128), for the step's breakdown.
    step_ms = {k: v[0]["ms"] for k, v in results.items()}
    step_bound = {k: v[0]["bound_ms"] for k, v in results.items()}
    step_tc = {k: v[0]["tc_bound_ms"] for k, v in results.items()}
    with torch.no_grad():
        for rows in (n // 2, n // 8):
            xk, _ = sample_rows(rows, seed=10)
            step_ms[f"sdf_value_{rows}"] = cuda_ms(
                lambda: SV.sdf_value_cuda(sdf_net, xk), reps=5)
            step_bound[f"sdf_value_{rows}"] = bound_ms(
                *k2_work(scfg, rows, sdf_net))[0]
            step_tc[f"sdf_value_{rows}"] = tc_bound_ms(*k2_work(scfg, rows, sdf_net))
        step_ms["rendercore_fwd"] = cuda_ms(
            lambda: RC.rendercore_fwd_cuda(sdf_net, color_net, x, d), reps=5)
        step_bound["rendercore_fwd"] = bound_ms(
            *k1_work(scfg, ccfg, n, sdf_net, color_net))[0]
        # The value pack a train step builds once for its K2 and K3
        # launches (glue): wall time per call, and its kernels' device time.
        def value_pack():
            return pack.pack_sdf_value_layers(pack.effective_layers(sdf_net))

        from kernel_times import kernel_split

        pack_ms = cuda_ms(value_pack, reps=5)
        pack_split = kernel_split(value_pack, 5)
    log("step_shapes", rows=n, kernel_ms=step_ms, bound_ms=step_bound,
        tc_bound_ms={**step_tc, "rendercore_fwd": tc_bound_ms(
            *k1_work(scfg, ccfg, n, sdf_net, color_net))},
        value_pack_ms=pack_ms,
        value_pack_device_ms=sum(pack_split.values()) if pack_split else "not measured")
    del x, d, cots, xs, xk
    torch.cuda.empty_cache()
    for k in results:
        results[k] = {"max_abs_err": errs[k], "times": results[k]}
    return results, step_ms


def phase_composed_kernels(fields):
    """K4 (outgrad) and K5 (color) on the perturbed full-width nets of the
    negative-ray config: the forward kernels against their plain versions
    (K5 on the composed path's inputs: dirs and grad negated, the feature a
    slice of the plain head), the backward kernels through their
    autograd.Functions against autograd of the plain versions and an f64
    evaluation, at 262,144 and 1,000 rows (K4 for the head's column 0, its
    feature columns and gbar alone, then all; K5 with no color cotangent on
    rows with a color ReLU within KINK_MARGIN of its kink); then CUDA-event
    times at the render chunk's and the train step's shapes."""
    import torch
    from copenerf_torch.ops.kernels import color as CK
    from copenerf_torch.ops.kernels import outgrad as OG
    from copenerf_torch.ops.kernels import pack

    sdf_net, color_net = fields["sdf"], fields["color"]
    scfg, ccfg = sdf_net.cfg, color_net.cfg
    sdf64, color64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    sdf_params, color_params = list(sdf_net.parameters()), list(color_net.parameters())
    sdf_names = ["x"] + [f"sdf.{k}" for k, _ in sdf_net.named_parameters()]
    color_names = (["x", "dirs", "grad", "feat"]
                   + [f"color.{k}" for k, _ in color_net.named_parameters()])
    errs = dict.fromkeys(("sdf_outgrad_fwd", "sdf_outgrad_bwd", "color_fwd",
                          "color_bwd"), 0.0)
    col0 = torch.zeros(scfg.d_out, device=DEVICE)
    col0[0] = 1.0
    for n in CHECK_ROWS:
        x, d = sample_rows(n, seed=n + 21)
        with torch.no_grad():
            got = OG.sdf_outgrad_cuda(sdf_net, x)
            ref_out, ref_grad = OG.sdf_outgrad_plain(sdf_net, x)
        torch.cuda.synchronize()
        errs["sdf_outgrad_fwd"] = max(errs["sdf_outgrad_fwd"], check_forward(
            "sdf_outgrad_fwd", ("out", "grad"), got, (ref_out, ref_grad), n))
        del got
        ins = [x, -d, -ref_grad, ref_out[:, 1:]]
        with torch.no_grad():
            e = (CK.color_fwd_cuda(color_net, *ins)
                 - CK.color_plain(color_net, *ins)).abs().max().item()
        log("check", kernel="color_fwd", rows=n, max_abs_err=e, tol=1e-4)
        if not e <= 1e-4:
            fail(f"color_fwd at {n} rows: err {e} > 1e-4")
        errs["color_fwd"] = max(errs["color_fwd"], e)

        g = torch.Generator(device=DEVICE).manual_seed(n + 1)
        obar = torch.randn((n, scfg.d_out), generator=g, device=DEVICE)
        gbar = torch.randn((n, 4), generator=g, device=DEVICE)
        e = check_channels(
            "sdf_outgrad_bwd", n, sdf_names, lambda a: OG.sdf_outgrad(sdf_net, a),
            lambda f64, a: OG.sdf_outgrad_plain(sdf64 if f64 else sdf_net, a),
            [x], sdf_params, list(sdf64.parameters()), [obar, gbar],
            [("sbar", (col0, 0.0)), ("feat", (1.0 - col0, 0.0)),
             ("gbar", (0.0 * col0, 1.0)), ("all", (torch.ones_like(col0), 1.0))],
            32768)
        errs["sdf_outgrad_bwd"] = max(errs["sdf_outgrad_bwd"], e)

        ins = [t.contiguous() for t in ins]
        margin = CK.color_relu_margin(color64, *[t.double() for t in ins])
        smooth = (margin >= KINK_MARGIN).float()
        log("kinks", kernel="color_bwd", rows=n, margin=KINK_MARGIN,
            cbar_zeroed_share=1.0 - smooth.mean().item())
        cbar = torch.randn((n, 3), generator=g, device=DEVICE) * smooth[:, None]
        got = _vjp(lambda *a: CK.color_mlp(color_net, *a), ins, color_params, [cbar])
        ref = _vjp(lambda *a: CK.color_plain(color_net, *a), ins, color_params,
                   [cbar])
        ref64 = _vjp(lambda *a: CK.color_plain(color64, *a),
                     [t.double() for t in ins], list(color64.parameters()),
                     [cbar.double()])
        e = check_grads(dict(kernel="color_bwd", rows=n), color_names, got, ref,
                        ref64)
        errs["color_bwd"] = max(errs["color_bwd"], e)
        del x, d, ins, got, ref, ref64, ref_out, ref_grad, margin
        torch.cuda.empty_cache()

    # Times at the render chunk's shapes: 32768 rays x 128 samples. The
    # plain versions in 8 slices, as for K1-fwd.
    results, step_ms = {}, {}
    n = CHUNK * 128
    sl = n // 8
    x, d = sample_rows(n, seed=12)
    with torch.no_grad():
        k_ms = cuda_ms(lambda: OG.sdf_outgrad_cuda(sdf_net, x), reps=3)
        p_ms = cuda_ms(lambda: [OG.sdf_outgrad_plain(sdf_net, x[i:i + sl])
                                for i in range(0, n, sl)], reps=1)
        bd = bounds(*k4_fwd_work(scfg, n, sdf_net))
        load = smi_under_load(lambda: OG.sdf_outgrad_cuda(sdf_net, x), k_ms)
        log("time", kernel="sdf_outgrad_fwd", rows=n, kernel_ms=k_ms,
            plain_ms=p_ms, plain_note="8 slices of 524288 rows", **bd,
            sm_clock_power_under_kernel=load)
        results["sdf_outgrad_fwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd)]
        out, grad = OG.sdf_outgrad_cuda(sdf_net, x)
        ins = [x, -d, -grad, out[:, 1:]]
        k_ms = cuda_ms(lambda: CK.color_fwd_cuda(color_net, *ins), reps=3)
        p_ms = cuda_ms(lambda: [CK.color_plain(color_net, *[t[i:i + sl] for t in ins])
                                for i in range(0, n, sl)], reps=1)
        bd = bounds(*k5_fwd_work(ccfg, n, color_net))
        load = smi_under_load(lambda: CK.color_fwd_cuda(color_net, *ins), k_ms)
        log("time", kernel="color_fwd", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
            plain_note="8 slices of 524288 rows", **bd,
            sm_clock_power_under_kernel=load)
        results["color_fwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd)]
        del x, d, out, grad, ins
    torch.cuda.empty_cache()

    # Times at the train step's shapes: 1024 rays x 128 samples.
    n = STEP_ROWS
    x, d = sample_rows(n, seed=13)
    g = torch.Generator(device=DEVICE).manual_seed(13)
    obar = torch.randn((n, scfg.d_out), generator=g, device=DEVICE)
    gbar = torch.randn((n, 4), generator=g, device=DEVICE)
    cbar = torch.randn((n, 3), generator=g, device=DEVICE)
    with torch.no_grad():
        og_pack, cl_pack = pack.pack_outgrad(sdf_net), pack.pack_color(color_net)
        step_ms["sdf_outgrad_fwd"] = cuda_ms(lambda: OG.sdf_outgrad_cuda(sdf_net, x),
                                             reps=5)
        out, grad = OG.sdf_outgrad_cuda(sdf_net, x)
        ins = [x, -d, -grad, out[:, 1:]]
        step_ms["color_fwd"] = cuda_ms(lambda: CK.color_fwd_cuda(color_net, *ins),
                                       reps=5)
    k_ms = cuda_ms(lambda: OG.outgrad_bwd_cuda(scfg, og_pack, x, obar, gbar), reps=3)
    # The plain backward: autograd.grad over a prebuilt double-backward
    # graph, in 4 slices of 32,768 rows (the whole graph does not fit).
    p_ms = 0.0
    for i in range(0, n, 32768):
        xs = x[i:i + 32768].clone().requires_grad_(True)
        o = OG.sdf_outgrad_plain(sdf_net, xs)
        cs = [obar[i:i + 32768], gbar[i:i + 32768]]
        p_ms += cuda_ms(lambda: torch.autograd.grad(o, [xs] + sdf_params, cs,
                                                    retain_graph=True), reps=2)
        del o
    bd = bounds(*k4_bwd_work(scfg, n, sdf_net))
    load = smi_under_load(lambda: OG.outgrad_bwd_cuda(scfg, og_pack, x, obar, gbar),
                          k_ms)
    row_ms, red_ms, split = split_ms(lambda: OG.outgrad_bwd_cuda(
        scfg, og_pack, x, obar, gbar), 3, "sdf_outgrad_bwd_kernel")
    log("time", kernel="sdf_outgrad_bwd", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
        plain_note="autograd.grad of the plain version, 4 slices of 32768 rows",
        **bd, row_kernel_ms=row_ms, reduction_ms=red_ms, kernel_split_ms=split,
        reduction_mm_ms=reduction_mm_ms("sdf_outgrad_bwd", scfg, ccfg, n),
        reduction_mm_note=MM_NOTE,
        sm_clock_power_under_kernel=load)
    results["sdf_outgrad_bwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd)]
    step_ms["sdf_outgrad_bwd"] = k_ms
    torch.cuda.empty_cache()

    k_ms = cuda_ms(lambda: CK.color_bwd_cuda(ccfg, cl_pack, *ins, cbar), reps=3)
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    o = CK.color_plain(color_net, *leaves)
    p_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves + color_params, cbar,
                                               retain_graph=True), reps=3)
    del o
    bd = bounds(*k5_bwd_work(ccfg, n, color_net))
    load = smi_under_load(lambda: CK.color_bwd_cuda(ccfg, cl_pack, *ins, cbar), k_ms)
    row_ms, red_ms, split = split_ms(lambda: CK.color_bwd_cuda(ccfg, cl_pack, *ins, cbar),
                                     3, "color_bwd_kernel")
    log("time", kernel="color_bwd", rows=n, kernel_ms=k_ms, plain_ms=p_ms,
        plain_note="autograd.grad of the plain version", **bd, row_kernel_ms=row_ms,
        reduction_ms=red_ms, kernel_split_ms=split,
        reduction_mm_ms=reduction_mm_ms("color_bwd", scfg, ccfg, n),
        reduction_mm_note=MM_NOTE,
        sm_clock_power_under_kernel=load)
    results["color_bwd"] = [dict(rows=n, ms=k_ms, plain_ms=p_ms, **bd)]
    step_ms["color_bwd"] = k_ms
    log("composed_step_shapes", rows=n, kernel_ms=step_ms)
    del x, d, obar, gbar, cbar, out, grad, ins, leaves
    torch.cuda.empty_cache()
    for k in results:
        results[k] = {"max_abs_err": errs[k], "times": results[k]}
    return results, step_ms


def check_forward(kernel, names, got, ref, rows):
    """Forward outputs against the plain version: 1e-4 absolute (grad 1e-4
    x max(1, max|grad|)). Returns the largest error."""
    worst = 0.0
    for name, g_, r_ in zip(names, got, ref):
        scale = max(1.0, r_.abs().max().item()) if name == "grad" else 1.0
        e = (g_ - r_).abs().max().item()
        tol = 1e-4 * scale
        log("check", kernel=kernel, output=name, rows=rows, max_abs_err=e, tol=tol)
        if not e <= tol:
            fail(f"{kernel} {name} at {rows} rows: err {e} > {tol}")
        worst = max(worst, e)
    return worst


def check_channels(kernel, n, names, kernel_fn, plain_fn, inputs, params, params64,
                   full, channels, slices):
    """The backward of ``kernel_fn`` against autograd of ``plain_fn(nets,
    *inputs)`` in f32 and f64 (``slices`` rows at a time), for each cotangent
    mask of ``channels`` in turn (the last with all on: its scales are the
    sums of the channels' norms). Returns the largest |kernel - plain|."""
    import torch

    worst, chan_norms = 0.0, []
    inputs64 = [t.double() for t in inputs]
    for chan, on in channels:
        cots = [c * m for c, m in zip(full, on)]
        got = _vjp(kernel_fn, inputs, params, cots)
        ref = _vjp_slices(lambda *a: plain_fn(False, *a), inputs, params, cots,
                          slices)
        ref64 = _vjp_slices(lambda *a: plain_fn(True, *a), inputs64, params64,
                            [c.double() for c in cots], slices // 2)
        torch.cuda.synchronize()
        scales = None
        if chan == "all":
            scales = [sum(t) for t in zip(*chan_norms)]
        else:
            chan_norms.append([c.norm().item() for c in ref64])
        worst = max(worst, check_grads(dict(kernel=kernel, rows=n, channel=chan),
                                       names, got, ref, ref64, scales))
        del got, ref, ref64
    return worst


def alternate_ms(fns, reps):
    """CUDA-event ms of each of ``fns`` (name -> fn), in turns a, b, b, a:
    the mean of its two readings."""
    ms = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for k in order:
        ms[k].append(cuda_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def phase_fold_kernels(fields):
    """K6, the render core with the consistency query at y folded into its
    launches, on the perturbed full-width nets (idr, positive ray): K6-fwd
    against ``rendercore_cons_plain`` and K6-bwd (``RenderCoreCons``)
    against autograd of it and f64 for sbar, gbar, cbar (KINK_MARGIN rule),
    swbar alone and all four, at 262,144 and 1,000 rows; then times at the
    train step's shapes (131,072 rows) beside the composed pair K1 + K3
    timed in turns in the same call (the fold-versus-two-launches
    measurement), the plain version and the bounds."""
    import torch
    from copenerf_torch.ops.kernels import pack
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import rendercore_cons as RCC
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

    sdf_net, color_net = fields["sdf"], fields["color"]
    scfg, ccfg = sdf_net.cfg, color_net.cfg
    nets64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    params = [*sdf_net.parameters(), *color_net.parameters()]
    params64 = [*nets64[0].parameters(), *nets64[1].parameters()]
    names = (["x", "dirs", "y"] + [f"sdf.{k}" for k, _ in sdf_net.named_parameters()]
             + [f"color.{k}" for k, _ in color_net.named_parameters()])
    errs = {"rendercore_cons_fwd": 0.0, "rendercore_cons_bwd": 0.0}
    outs = ("sdf", "grad", "color", "sdf_w")
    for n in CHECK_ROWS:
        x, d = sample_rows(n, seed=n + 31)
        y, _ = sample_rows(n, seed=n + 32)
        with torch.no_grad():
            got = RCC.rendercore_cons(sdf_net, color_net, x, d, y)
            ref = RCC.rendercore_cons_plain(sdf_net, color_net, x, d, y)
        torch.cuda.synchronize()
        errs["rendercore_cons_fwd"] = max(errs["rendercore_cons_fwd"], check_forward(
            "rendercore_cons_fwd", outs, got, ref, n))
        del got, ref
        g = torch.Generator(device=DEVICE).manual_seed(n + 3)
        full = [torch.randn(s, generator=g, device=DEVICE)
                for s in ((n, 1), (n, 4), (n, 3), (n,))]
        margin = RC.color_relu_margin(*nets64, x.double(), d.double())
        smooth = (margin >= KINK_MARGIN).float()
        log("kinks", kernel="rendercore_cons_bwd", rows=n, margin=KINK_MARGIN,
            cbar_zeroed_share=1.0 - smooth.mean().item())
        full[2] = full[2] * smooth[:, None]
        del margin
        e = check_channels(
            "rendercore_cons_bwd", n, names,
            lambda *a: RCC.rendercore_cons(sdf_net, color_net, *a),
            lambda f64, *a: RCC.rendercore_cons_plain(
                *(nets64 if f64 else (sdf_net, color_net)), *a),
            [x, d, y], params, params64, full,
            [(c, [float(i == k) for i in range(4)])
             for k, c in enumerate(("sbar", "gbar", "cbar", "swbar"))]
            + [("all", [1.0] * 4)], 32768)
        errs["rendercore_cons_bwd"] = max(errs["rendercore_cons_bwd"], e)
        del x, d, y, full
        torch.cuda.empty_cache()

    # Times at the train step's shapes: the fold against K1 + K3, in turns.
    n = STEP_ROWS
    x, d = sample_rows(n, seed=14)
    y, _ = sample_rows(n, seed=15)
    g = torch.Generator(device=DEVICE).manual_seed(14)
    cots = [torch.randn(s, generator=g, device=DEVICE)
            for s in ((n, 1), (n, 4), (n, 3), (n,))]
    with torch.no_grad():
        rc_pack = pack.pack_rendercore(sdf_net, color_net)
        v_pack = pack.pack_sdf_value_layers(pack.effective_layers(sdf_net))
    fwd = alternate_ms({
        "fold": lambda: RCC.launch_cons_fwd(scfg, ccfg, rc_pack, x, d, y),
        "pair": lambda: (RC.launch_fwd(scfg, ccfg, rc_pack, x, d),
                         SVD.launch_value(scfg, v_pack, y, SVD.FWD_COUNTER))}, 5)
    bwd = alternate_ms({
        "fold": lambda: RCC.rendercore_cons_bwd_cuda(scfg, ccfg, rc_pack, x, d, y,
                                                     *cots),
        "pair": lambda: (RC.rendercore_bwd_cuda(scfg, ccfg, rc_pack, x, d, *cots[:3]),
                         SVD.sdf_value_bwd_cuda(scfg, v_pack, y, cots[3]))}, 3)
    with torch.no_grad():
        p_fwd = cuda_ms(lambda: RCC.rendercore_cons_plain(sdf_net, color_net, x, d, y),
                        reps=3)
    # The plain backward: autograd.grad over a prebuilt graph, in 4 slices.
    p_bwd = 0.0
    for i in range(0, n, 32768):
        ins = [t[i:i + 32768].clone().requires_grad_(True) for t in (x, d, y)]
        out = RCC.rendercore_cons_plain(sdf_net, color_net, *ins)
        cs = [c[i:i + 32768] for c in cots]
        p_bwd += cuda_ms(lambda: torch.autograd.grad(out, ins + params, cs,
                                                     retain_graph=True), reps=2)
        del out, ins
    results = {}
    row_ms, red_ms, split = split_ms(lambda: RCC.rendercore_cons_bwd_cuda(
        scfg, ccfg, rc_pack, x, d, y, *cots), 3, "rendercore_bwd_kernel")
    for name, t, p_ms, work, extra in (
            ("rendercore_cons_fwd", fwd, p_fwd, k6_fwd_work, {}),
            ("rendercore_cons_bwd", bwd, p_bwd, k6_bwd_work,
             dict(row_kernel_ms=row_ms, reduction_ms=red_ms, kernel_split_ms=split,
                  reduction_mm_ms=reduction_mm_ms("rendercore_cons_bwd", scfg, ccfg, n),
                  reduction_mm_note=MM_NOTE))):
        wk = work(scfg, ccfg, n, sdf_net, color_net)
        b, by = bound_ms(*wk)
        log("time", kernel=name, rows=n, kernel_ms=t["fold"],
            k1_plus_k3_ms=t["pair"], fold_over_pair=t["fold"] / t["pair"],
            timing_note="fold and pair in turns a, b, b, a; means of two",
            plain_ms=p_ms, bound_ms=b, bound_by=by, tc_bound_ms=tc_bound_ms(*wk),
            **extra)
        results[name] = {"max_abs_err": errs[name], "times": [dict(
            rows=n, ms=t["fold"], plain_ms=p_ms, bound_ms=b, bound_by=by,
            tc_bound_ms=tc_bound_ms(*wk))]}
    log("fold_vs_two_launches", rows=n,
        fold_ms=fwd["fold"] + bwd["fold"], k1_plus_k3_ms=fwd["pair"] + bwd["pair"],
        fold_fwd_ms=fwd["fold"], pair_fwd_ms=fwd["pair"],
        fold_bwd_ms=bwd["fold"], pair_bwd_ms=bwd["pair"])
    step = {"rendercore_cons_fwd": fwd["fold"], "rendercore_cons_bwd": bwd["fold"]}
    del x, d, y, cots
    torch.cuda.empty_cache()
    return results, step


def phase_out_kernels(fields, counters):
    """K7, the SDF output with a first-order backward, on the perturbed
    full-width SDF net: first ``fields.sdf_output`` driven once forward and
    backward at the train step's rows with the launch counters zeroed just
    before and read just after (1 K7-fwd + 1 K7-bwd, nothing else); then
    K7-fwd against ``sdf_apply`` and K7-bwd against autograd of it and f64
    for the head's cotangent on column 0, on the feature columns and on all,
    at 262,144 and 1,000 rows; then times at 131,072 rows beside the plain
    version and the bounds."""
    import torch
    from copenerf_torch.models import fields as F
    from copenerf_torch.ops.kernels import pack
    from copenerf_torch.ops.kernels import sdf_out as SO

    sdf_net = fields["sdf"]
    scfg = sdf_net.cfg
    sdf64 = copy.deepcopy(sdf_net).double()
    params, params64 = list(sdf_net.parameters()), list(sdf64.parameters())
    names = ["x"] + [f"sdf.{k}" for k, _ in sdf_net.named_parameters()]

    n = STEP_ROWS
    x, _ = sample_rows(n, seed=16)
    xg = x.clone().requires_grad_(True)
    for c in counters:
        c.launches = 0
    F.sdf_output(sdf_net, xg).square().sum().backward()
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters}
    want = {c.name: int(c in (SO.FWD_COUNTER, SO.BWD_COUNTER)) for c in counters}
    log("sdf_output", rows=n, launches=launches, expected=want)
    if launches != want:
        fail(f"sdf_output launch counts {launches} != {want}")
    for p in params:
        p.grad = None
    del xg

    errs = {"sdf_out_fwd": 0.0, "sdf_out_bwd": 0.0}
    col0 = torch.zeros(scfg.d_out, device=DEVICE)
    col0[0] = 1.0
    for n in CHECK_ROWS:
        x, _ = sample_rows(n, seed=n + 41)
        with torch.no_grad():
            e = check_forward("sdf_out_fwd", ["out"], [F.sdf_output(sdf_net, x)],
                              [SO.sdf_out_plain(sdf_net, x)], n)
        errs["sdf_out_fwd"] = max(errs["sdf_out_fwd"], e)
        g = torch.Generator(device=DEVICE).manual_seed(n + 4)
        obar = torch.randn((n, scfg.d_out), generator=g, device=DEVICE)
        e = check_channels(
            "sdf_out_bwd", n, names, lambda a: F.sdf_output(sdf_net, a),
            lambda f64, a: SO.sdf_out_plain(sdf64 if f64 else sdf_net, a),
            [x], params, params64, [obar],
            [("sbar", [col0]), ("feat", [1.0 - col0]), ("all", [torch.ones_like(col0)])],
            65536)
        errs["sdf_out_bwd"] = max(errs["sdf_out_bwd"], e)
        del x, obar
        torch.cuda.empty_cache()

    n = STEP_ROWS
    x, _ = sample_rows(n, seed=17)
    obar = torch.randn((n, scfg.d_out), generator=torch.Generator(
        device=DEVICE).manual_seed(17), device=DEVICE)
    with torch.no_grad():
        og_pack = pack.pack_outgrad(sdf_net)
        k_fwd = cuda_ms(lambda: SO.launch_out_fwd(scfg, og_pack, x), reps=5)
        p_fwd = cuda_ms(lambda: SO.sdf_out_plain(sdf_net, x), reps=5)
    k_bwd = cuda_ms(lambda: SO.sdf_out_bwd_cuda(scfg, og_pack, x, obar), reps=5)
    xs = x.clone().requires_grad_(True)
    out = SO.sdf_out_plain(sdf_net, xs)
    p_bwd = cuda_ms(lambda: torch.autograd.grad(out, [xs] + params, obar,
                                                retain_graph=True), reps=3)
    del out
    row_ms, red_ms, split = split_ms(lambda: SO.sdf_out_bwd_cuda(scfg, og_pack, x, obar), 3,
                                     "sdf_out_bwd_kernel")
    extra = {"sdf_out_fwd": {}, "sdf_out_bwd": dict(
        row_kernel_ms=row_ms, reduction_ms=red_ms, kernel_split_ms=split,
        reduction_mm_ms=reduction_mm_ms("sdf_out_bwd", scfg, None, n),
        reduction_mm_note=MM_NOTE)}
    results = {}
    for name, k_ms, p_ms, work in (("sdf_out_fwd", k_fwd, p_fwd, k7_fwd_work),
                                   ("sdf_out_bwd", k_bwd, p_bwd, k7_bwd_work)):
        bd = bounds(*work(scfg, n, sdf_net))
        log("time", kernel=name, rows=n, kernel_ms=k_ms, plain_ms=p_ms,
            plain_note="the plain forward / autograd.grad of it", **bd, **extra[name])
        results[name] = {"max_abs_err": errs[name], "times": [dict(
            rows=n, ms=k_ms, plain_ms=p_ms, **bd)]}
    del x, xs, obar
    torch.cuda.empty_cache()
    return results, launches


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


def phase_main(cfg, fields, counters, per_chunk, views=VIEWS, phase="main"):
    """``views`` renders of the full-width model through ``render_image``;
    the launch counters are zeroed just before and read just after, and
    must show ``per_chunk`` launches of each named kernel per chunk and none
    of the others."""
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
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    view_ms = []
    outs = []
    for i in range(views):
        t0 = time.perf_counter()
        outs.append(one(i))
        view_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {c.name: c.launches for c in counters}
    n_chunks = views * -(-(h * w) // CHUNK)
    for i, res in enumerate(outs):
        for k, v in res.items():
            if not np.all(np.isfinite(v)):
                fail(f"{phase} view {i}: non-finite {k}")
        if res["color"].shape != (h, w, 3) or res["depth"].shape != (h, w):
            fail(f"{phase} view {i}: wrong output shapes")
        center = float(res["depth"][h // 2, w // 2])
        log("view", path=phase, view=i, frame=frames[i], ms=view_ms[i],
            rays_per_s=h * w / (view_ms[i] / 1e3), depth_center=center)
        # The centre ray meets the init sphere (radius 0.5, 2.5 away).
        if not 1.5 < center < 2.5:
            fail(f"{phase} view {i}: centre depth {center} misses the init sphere")
    want = {c.name: per_chunk.get(c.name, 0) * n_chunks for c in counters}
    log(phase, views=views, resolution=list(RES), chunk=CHUNK,
        chunks=n_chunks, launches=launches, expected=want,
        mean_view_ms=sum(view_ms) / views,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != want:
        fail(f"{phase} launch counts {launches} != {want}")
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def synthetic_video(seed):
    """(31, 3, 540, 960) uint8 on the card: per channel a smooth sinusoid
    whose phase moves from frame to frame, frequencies and phases from
    ``seed``."""
    import torch

    h, w = TRAIN_RES
    g = torch.Generator().manual_seed(seed)
    freq = (torch.rand((3, 2), generator=g) * 0.02 + 0.005).to(DEVICE)
    phase = (torch.rand((3,), generator=g) * 6.283).to(DEVICE)
    yy, xx = torch.meshgrid(torch.arange(h, device=DEVICE, dtype=torch.float32),
                            torch.arange(w, device=DEVICE, dtype=torch.float32),
                            indexing="ij")
    frames = []
    for t in range(N_FRAMES):
        ch = [0.5 + 0.4 * torch.sin(freq[c, 0] * xx + freq[c, 1] * yy
                                    + phase[c] + 0.15 * t) for c in range(3)]
        frames.append((torch.stack(ch) * 255.0).round().to(torch.uint8))
    return torch.stack(frames)


def train_setup(cfg, seed):
    """(StepStatic, RendererConfig, batch) of the stage-1 step at the
    reference protocol: image 16 of the video, the world camera 15 (the
    middle frame), references 17-19 (``random_ref_interval`` 1, 2, 3), the
    camera CAM_DIST from the init sphere's centre, one fixed set of 64 4x4 patches
    and jitter drawn on the card (``inject_sampling``)."""
    import torch
    from copenerf_torch.ops.renderer import RendererConfig
    from copenerf_torch.training import step as TS

    tc = cfg["training"]
    h, w = TRAIN_RES
    n_rays = tc["n_training_points"]
    rcfg = RendererConfig.from_cfg(cfg)
    s = TS.StepStatic(
        h=h, w=w, patch_size=tc["patch_size"], n_points=n_rays, stage1=True,
        n_images=N_FRAMES, nb_sample_timestep=tc["nb_sample_timestep"],
        n_ref=len(cfg["dataloading"]["random_ref_interval"]), train_motion=True,
        sdf_cons_pose_grad=tc["sdf_consistency_enable_pose_grad"],
        use_flow_rgb=True, use_sdf_consistency=True, inject_sampling=True)
    world = torch.eye(4, device=DEVICE)
    world[2, 3] = -CAM_DIST
    K = torch.as_tensor(camera(h, w), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    image, world_cam = 16, N_FRAMES // 2
    depth_range = cfg["rendering"]["depth_range"]
    stage = 0
    batch = {
        "images_all": synthetic_video(seed),
        "K_all": K.expand(N_FRAMES, 4, 4).contiguous(),
        "ref_idxs": torch.tensor([image + i for i in
                                  cfg["dataloading"]["random_ref_interval"]],
                                 device=DEVICE),
        "ref_in_list": torch.ones(3, device=DEVICE),
        "ref_valid_flow": torch.ones(3, device=DEVICE),
        "scale_mat": torch.eye(4, device=DEVICE), "world_mat": world,
        "image_idx": torch.tensor(image, device=DEVICE),
        "world_cam_idx": torch.tensor(world_cam, device=DEVICE),
        "query_time_step": torch.tensor(time_of(image), device=DEVICE),
        "world_time_step": torch.tensor(time_of(world_cam), device=DEVICE),
        "near": float(depth_range[0]), "far": float(depth_range[1]),
        "cos_anneal_ratio": 0.5,
        # Stage-1 weights of configs/default.yaml; the sdf-consistency
        # weight is annealed from 0 to 1, here half way.
        "loss_weights": TS.make_loss_weights(
            tc["rgb_weight"][stage], tc["eikonal_weight"][stage],
            tc["sdf_weight"][stage], tc["flow_rgb_weight"][stage], 0.5,
            tc["edge_aware_smoothness_weight"][stage],
            tc["smoothness_weight"][stage]),
        "lr": tc["learning_rate"], "motion_lr": tc["pose_learning_rate"],
        "ray_idx": TS.sample_patch_indices(gen, h, w, s.patch_size, n_rays,
                                           device=DEVICE),
        "t_rand": torch.rand((n_rays, rcfg.n_samples), generator=gen,
                             device=DEVICE),
    }
    return s, rcfg, batch


def phase_train(cfg, fields, counters, step_ms, per_step, steps=TRAIN_STEPS,
                window=5, phase="train"):
    """``steps`` stage-1 steps on a copy of the main path's nets, one fixed
    batch; launch counters zeroed just before and read just after, which
    must show ``per_step`` launches of each named kernel per step and none
    of the others. ``step_ms``: each kernel's time alone at the step's
    shapes, for the kernels / glue split of the mean step; the loss must be
    finite and its mean over the last ``window`` steps below that over the
    first."""
    import numpy as np
    import torch
    from copenerf_torch.training import step as TS

    s, rcfg, batch = train_setup(cfg, seed=5)
    state = TS.init_train_state(copy.deepcopy(fields))
    step = TS.build_train_step(rcfg, s)
    tc = cfg["training"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    losses, times = [], []
    for i in range(steps):
        # The first iterations of a run: the field lr warms up linearly over
        # nb_warm_up_it iterations, the motion lr does not (the trainer's
        # schedule).
        batch["lr"] = tc["learning_rate"] * min(i / tc["nb_warm_up_it"], 1.0)
        t0 = time.perf_counter()
        m = step(state, batch)
        loss = float(m["loss"])          # a host copy: the step has ended
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        log("step", path=phase, step=i, loss=loss, ms=times[-1],
            loss_rgb=float(m["loss_rgb"]), loss_flow_rgb=float(m["loss_flow_rgb"]),
            sdf_consistency_loss=float(m["sdf_consistency_loss"]),
            psnr=float(m["psnr"]))
    launches = {c.name: c.launches for c in counters}
    want = {c.name: per_step.get(c.name, 0) * steps for c in counters}
    mean_ms = float(np.mean(times[1:]))
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    kernel_ms = (step_ms[f"sdf_value_{STEP_ROWS // 2}"]
                 + 3 * step_ms[f"sdf_value_{STEP_ROWS // 8}"]
                 + sum(step_ms[k] * count for k, count in per_step.items()
                       if k != "sdf_value"))
    STEP_MEAN_MS[phase] = mean_ms
    log(phase, steps=steps, rays=s.n_points, resolution=list(TRAIN_RES),
        launches=launches, expected=want, mean_step_ms=mean_ms,
        mean_step_ms_note=f"steps 1..{steps - 1} (step 0 allocates)",
        kernel_ms_per_step=kernel_ms, glue_ms_per_step=mean_ms - kernel_ms,
        rays_per_s=s.n_points / (mean_ms / 1e3),
        **{f"first{window}_mean_loss": first, f"last{window}_mean_loss": last},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not np.all(np.isfinite(losses)):
        fail(f"{phase}: non-finite train loss: {losses}")
    if not last < first:
        fail(f"{phase}: loss did not descend: first {window} {first}, "
             f"last {window} {last}")
    if launches != want:
        fail(f"{phase} launch counts {launches} != {want}")
    return launches, (s, rcfg, batch)


def step_grads(fields, rcfg, s, batch, ray_idx, t_rand):
    """(metrics, gradients of the fields group then the motion group) of
    one compute_losses + backward."""
    from copenerf_torch.training import step as TS

    for p in fields.parameters():
        p.grad = None
    total, metrics = TS.compute_losses(fields, rcfg, s, batch, ray_idx,
                                       t_rand=t_rand)
    total.backward()
    names, grads = [], []
    for k in (*TS.FIELD_NETS, "motion"):
        for nm, p in fields[k].named_parameters():
            names.append(f"{k}.{nm}")
            grads.append(p.grad.detach().cpu() if p.grad is not None
                         else p.detach().cpu() * 0)
    return {k: v.item() for k, v in metrics.items()}, names, grads


CONS_RTOL = 2e-3


def phase_train_card_vs_cpu(fields, checked, train, phase="train_card_vs_cpu",
                            pose_grad=None):
    """One step, 64 rays (4 patches of the train batch) and their jitter,
    on the card (kernels) and on the CPU (plain versions). Main-path nets:
    every metric within 1e-4 relative + 1e-6, every gradient tensor within
    ||d|| / ||ref|| <= 1e-3. Perturbed nets: as in the render check, the
    importance chain moves a sample on a few rays of that rough field for
    last-bit SDF differences, so the metrics get 1e-3 relative + 1e-5 and
    the gradient tensors ||d|| / ||ref|| <= 1e-2 (a gradient sums every ray,
    so the moved samples shift every entry of the global tensors, such as
    the variance and the motion net; a faulty kernel channel moves the
    tensors it reaches by O(1)). On both nets
    ``sdf_consistency_loss`` gets CONS_RTOL relative: it is the mean
    |sdf_w - sdf| (~5e-3) of SDF values near 1 at two poses of the motion
    chain (31 frames x 10 Euler substeps of 4x4 products), whose last bits
    differ between the card and the CPU, with the plain versions on the card
    as with the kernels. ``pose_grad`` overrides the config's
    ``sdf_consistency_enable_pose_grad`` (the sdf-consistency query's y
    cotangent then reaches the motion net's gradients)."""
    import torch
    from copenerf_torch.training import step as TS

    s, rcfg, batch = train
    s64 = TS.StepStatic(**{**s.__dict__, "n_points": 64,
                           "sdf_cons_pose_grad": (s.sdf_cons_pose_grad if pose_grad is None
                                                  else pose_grad)})
    idx, t_rand = batch["ray_idx"][:64], batch["t_rand"][:64]
    cpu_batch = {k: (v.cpu() if torch.is_tensor(v) else v)
                 for k, v in batch.items()}
    for nets, f in (("main", fields), ("perturbed", checked)):
        f_card = copy.deepcopy(f)
        t0 = time.perf_counter()
        m_card, names, g_card = step_grads(f_card, rcfg, s64, batch, idx, t_rand)
        card_ms = 1e3 * (time.perf_counter() - t0)
        f_cpu = copy.deepcopy(f).cpu()
        t0 = time.perf_counter()
        m_cpu, _, g_cpu = step_grads(f_cpu, rcfg, s64, cpu_batch, idx.cpu(),
                                     t_rand.cpu())
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        g_err = [rel_norm(a, b) for a, b in zip(g_card, g_cpu)]
        worst = max(range(len(g_err)), key=g_err.__getitem__)
        log(phase, nets=nets, rays=64, pose_grad=s64.sdf_cons_pose_grad,
            metrics_card=m_card,
            metrics_cpu=m_cpu,
            grad_worst_rel_norm=g_err[worst], grad_worst=names[worst],
            card_ms=card_ms, cpu_ms=cpu_ms)
        rtol, atol = (1e-4, 1e-6) if nets == "main" else (1e-3, 1e-5)
        bad_m = [k for k, v in m_cpu.items()
                 if not abs(m_card[k] - v) <= (CONS_RTOL if k == "sdf_consistency_loss"
                                               else rtol) * abs(v) + atol]
        g_tol = 1e-3 if nets == "main" else 1e-2
        bad_g = [nm for nm, e in zip(names, g_err) if not e <= g_tol]
        if bad_m or bad_g:
            fail(f"{phase} ({nets} nets): metrics {bad_m}, "
                 f"gradients {bad_g[:6]}")


def stage2_setup(cfg, train):
    """The train phase's (StepStatic, RendererConfig, batch) as a stage-2
    step: no flow-rgb or sdf-consistency terms (so no K3), the motion net
    frozen, the query at the world camera's time through a world_mat that
    rotates the camera 0.1 rad about y besides its shift, and the stage-2
    loss weights of the config."""
    import math

    import torch
    from copenerf_torch.training import step as TS

    s, rcfg, batch = train
    tc = cfg["training"]
    c, sn = math.cos(0.1), math.sin(0.1)
    rot = torch.tensor([[c, 0, sn, 0], [0, 1, 0, 0], [-sn, 0, c, 0],
                        [0, 0, 0, 1]], device=DEVICE)
    batch = dict(
        batch, world_mat=rot @ batch["world_mat"],
        query_time_step=batch["world_time_step"],
        loss_weights=TS.make_loss_weights(
            *(tc[k][1] for k in ("rgb_weight", "eikonal_weight", "sdf_weight",
                                 "flow_rgb_weight", "sdf_consistency_weight",
                                 "edge_aware_smoothness_weight",
                                 "smoothness_weight"))))
    s = TS.StepStatic(**{**s.__dict__, "stage1": False, "train_motion": False})
    return s, rcfg, batch


# ---------------------------------------------------------------------------
# The Trainer: scene on disk -> stage-1 epochs -> checkpoint -> resume
# ---------------------------------------------------------------------------

def trainer_config(scene, out_dir):
    """(cfg, cuts): configs/default.yaml (SDF 52->256x8->257, color
    291->256x4->3, 1024 rays as 64 4x4 patches, 64 + 64 samples) with the
    phase's overrides of it, each a cut."""
    from copenerf_torch.config.loader import load_config

    cuts = {
        "dataloading.path": scene[0], "dataloading.scene": [scene[1]],
        "training.out_dir": out_dir,
        "training.original_resolution": list(TRAINER_RES),
        "training.resolution": list(TRAINER_RES),
        "training.nb_warm_up_it": 10,
        "training.depth_bound_update_every_milestones": [5, 5, 5],
        "training.eval_pose_every": 1, "training.checkpoint_every": 1,
        "training.pretrained_sdf_path": None,
        "training.start_query_world_epoch": 100,
        # A torch.profiler window over iterations 16-20 (the port's Trainer
        # traces 5 iterations from there).
        "training.profile_trace_at_it": 16,
    }
    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    for key, value in cuts.items():
        section, name = key.split(".")
        cfg[section][name] = value
    return cfg, cuts


def render_chunks(renderer, h, w):
    """The chunks ``render_image`` splits an (h, w) view into."""
    chunk = renderer.min_chunk
    while chunk < h * w and chunk < renderer.chunk:
        chunk *= 2
    return -(-(h * w) // chunk)


def phase_trainer(counters):
    """``Trainer(cfg).train(max_epochs=2)`` on a Co3D-convention synthetic
    scene written by the port's ``data/synthetic.py`` (12 frames at
    270x480: 11 train views, 22 iterations), then a second ``Trainer`` on
    the same out_dir resumes from the epoch-1 checkpoint and trains 1 more
    epoch. Gates: finite epoch losses, the last epoch's mean below the
    first's; launch counters zeroed before the first ``train`` and read after
    the second (per step 4 K2 + 1 K1-fwd + 1 K1-bwd + 1 K3-fwd + 1 K3-bwd,
    per visualization chunk 4 K2 + 1 K1-fwd, no K4-K7); every visualization
    wrote its images; the resumed state equals the saved one; the
    checkpoint's flat Adam moments have the JAX layout's lengths; finite
    pose metrics; a 2-view ``render_train_views`` with finite depths."""
    import tempfile

    import numpy as np
    import torch
    from copenerf_torch.data.synthetic import make_scene
    from copenerf_torch.training import step as TS
    from copenerf_torch.training.checkpoints import _flatten
    from copenerf_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene = make_scene(os.path.join(tmp, "scene"), n_frames=TRAINER_FRAMES,
                           h=TRAINER_RES[0], w=TRAINER_RES[1])
        out_dir = os.path.join(tmp, "out")
        cfg, cuts = trainer_config(scene, out_dir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        first = Trainer(copy.deepcopy(cfg), verbose=False)
        first.train(max_epochs=2)
        saved = _flatten(TS.train_state_to_jax(first.state))
        second = Trainer(copy.deepcopy(cfg), verbose=False)
        resumed_it = second.it
        resumed = _flatten(TS.train_state_to_jax(second.state))
        second.train(max_epochs=1)
        launches = {c.name: c.launches for c in counters}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        its = second.it + 1
        n_vis = sum(1 for it in range(its) if it % 5 == 0)
        vis_chunks = n_vis * render_chunks(second.image_renderer,
                                           *cfg["training"]["vis_resolution"])
        per_step = {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1,
                    "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1}
        per_chunk = {"sdf_value": 4, "rendercore_fwd": 1}
        want = {c.name: per_step.get(c.name, 0) * its
                + per_chunk.get(c.name, 0) * vis_chunks for c in counters}
        vis_dirs = [d for d in os.listdir(os.path.join(out_dir, "rendering"))
                    if d.endswith("_vis")
                    and len(os.listdir(os.path.join(out_dir, "rendering", d))) == 5]

        logs = os.path.join(out_dir, "logs")
        scalars = [json.loads(ln) for ln in open(os.path.join(logs, "scalars.jsonl"))]
        epoch_loss = {d["step"]: d["value"] for d in scalars
                      if d["tag"] == "loss_epoch/loss"}
        journal = [json.loads(ln) for ln in open(os.path.join(logs, "throughput.jsonl"))]
        epochs = {d["epoch"]: d for d in journal if "epoch" in d}
        with np.load(os.path.join(out_dir, "models", "weights", "model.ckpt.npz")) as ck:
            moments = {k: (ck[f"{k}/#1"].size, ck[f"{k}/#2"].size)
                       for k in TS.OPTIMIZER_NETS}
        n_params = {k: sum(p.numel() for n in nets
                           for p in second.state["fields"][n].parameters())
                    for k, nets in TS.OPTIMIZER_NETS.items()}
        _, rpe_t, rpe_r, ate = second.pose_evaluation()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depths = second.render_train_views(views=[0, 1])
        views_ms = 1e3 * (time.perf_counter() - t0)
        prof = first.profile_summary or {}
        same = (set(saved) == set(resumed)
                and all(np.array_equal(v, resumed[k]) for k, v in saved.items()))

    log("trainer", cuts=cuts, frames=TRAINER_FRAMES, train_views=second.train_field.N_imgs,
        iterations=its, saved_at_it=first.it, resumed_at_it=resumed_it,
        epoch_loss=epoch_loss,
        launches=launches, expected=want, visualizations=n_vis,
        vis_chunks=vis_chunks, vis_dirs_complete=len(vis_dirs),
        resumed_state_equal=same, adam_moments=moments, param_counts=n_params,
        ate=ate, rpe_trans=rpe_t, rpe_rot=rpe_r,
        render_train_views_ms=views_ms, depth_shape=list(depths.shape),
        phase_s=time.perf_counter() - t_phase)
    last = epochs.get(2, {})
    log("trainer_time", trainer_ms_per_it=last.get("ms_per_it"),
        trainer_ms_per_it_steps=last.get("ms_per_it_steps"),
        vis_ms=last.get("vis_ms"),
        note=("epoch 2 (the resumed Trainer: 11 iterations, visualizations at 25 "
              "and 30), host clock with a device sync at the loop's ends; _steps "
              "without the visualizations (each timed from a device sync)"),
        by_epoch={e: {k: d[k] for k in ("ms_per_it", "ms_per_it_steps", "vis_ms")}
                  for e, d in epochs.items()},
        bare_step_ms=STEP_MEAN_MS.get("train"),
        bare_step_ms_note="the train phase's mean step (one fixed batch, 540x960 video)")
    log("trainer_busy", iters=prof.get("iters"), first_it=prof.get("first_it"),
        wall_ms=prof.get("wall_ms"), device_busy_ms=prof.get("device_busy_ms"),
        busy_share=prof.get("busy_share"), ms_per_it_profiled=prof.get("ms_per_it"),
        wall_ms_outside_vis=prof.get("wall_ms_outside"),
        device_busy_ms_outside_vis=prof.get("device_busy_ms_outside"),
        busy_share_outside_vis=prof.get("busy_share_outside"),
        note=("torch.profiler over iterations 16-20 of the first Trainer (one "
              "visualization, at 20): the union of kernel, copy and memset "
              "intervals over the window's wall time; _outside_vis without the "
              "visualization's record_function range"))
    log("trainer_memory", peak_gb=peak_gb)
    losses = [epoch_loss.get(e, float("nan")) for e in range(3)]
    if not np.all(np.isfinite(losses)):
        fail(f"trainer: non-finite epoch losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"trainer: the last epoch's mean loss {losses[-1]} is not below "
             f"the first's {losses[0]}")
    if launches != want:
        fail(f"trainer launch counts {launches} != {want}")
    if len(vis_dirs) != n_vis:
        fail(f"trainer: {len(vis_dirs)} complete visualizations of {n_vis}")
    if not (same and resumed_it == first.it):
        fail("trainer: the resumed Trainer's state differs from the saved one")
    if moments != {k: (n, n) for k, n in n_params.items()}:
        fail(f"trainer: Adam moments {moments} != parameter counts {n_params}")
    if not np.all(np.isfinite([ate, rpe_t, rpe_r])):
        fail(f"trainer: pose metrics ate {ate}, rpe {rpe_t}, {rpe_r}")
    if depths.shape != (2,) + TRAINER_RES or not np.all(np.isfinite(depths)):
        fail(f"trainer: render_train_views depths {depths.shape}, finite "
             f"{bool(np.all(np.isfinite(depths)))}")
    if not (prof.get("busy_share") is not None and prof.get("iters") == 5):
        fail(f"trainer: no profiler window {prof}")
    return launches


def refine_pose_epochs(out_dir):
    """The refinement's per-epoch scalars from the Trainer's log, by tag."""
    rows = [json.loads(ln) for ln in
            open(os.path.join(out_dir, "logs", "scalars.jsonl"))]
    out = {}
    for d in rows:
        if d["tag"].startswith("poseRefine/"):
            out.setdefault(d["tag"].split("/")[1], []).append(d["value"])
    return out


class _Sink:
    """A logger that drops what it is given (the refinement's scalars)."""

    def add_scalar(self, tag, value, step):
        pass


def refine_ms_per_epoch(images, depths, k33, epochs, gt_poses=None):
    """Host-clock ms an epoch of ``run_pose_refinement`` on the card (the
    call ends in a host copy of the poses), with the host pose metrics when
    ``gt_poses`` is given."""
    import numpy as np
    import torch
    from copenerf_torch.evaluation.metrics_pose import pose_error_report
    from copenerf_torch.training.pose_refinement import run_pose_refinement

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses = run_pose_refinement(
        images, depths, k33, epochs=epochs, logger=_Sink(), gt_poses=gt_poses,
        pose_error_fn=pose_error_report, device=DEVICE)
    ms = 1e3 * (time.perf_counter() - t0) / epochs
    if not np.all(np.isfinite(poses)):
        fail("pose refinement: non-finite poses")
    return ms


def adam_counts(state):
    """Each optimizer's step count, as the JAX layout stores it."""
    from copenerf_torch.training import step as TS

    tree = TS.train_state_to_jax(state)
    return {k: int(tree[k].count) for k in TS.OPTIMIZER_NETS}


def phase_trainer_stage2(counters, tmp):
    """``Trainer(cfg).train(max_epochs=2)`` across the stage-1 -> stage-2
    transition on the ``trainer`` phase's scene and nets
    (``start_query_world_epoch`` 1, ``pose_refine_epochs`` 60, so the lr
    milestones at 30, 40 and 50 fire; ``refine_from_scratch`` false: after
    11 stage-1 iterations the field still renders every depth at the near
    plane, and from the identity, where a refinement from scratch starts,
    every pose move raises the warp loss, so only a start from the motion
    field's poses gives the refinement a descent to show): epoch 0 in stage
    1, then the
    transition (every train view rendered, the refinement, the refined
    poses written) and a stage-2 epoch, saved; a second ``Trainer`` resumes
    from that transition-epoch checkpoint on the refined poses and trains
    one more stage-2 epoch. Gates: finite epoch losses; no fallback; the
    refinement's loss falls from its first epoch to its last;
    ``refine_pose.npz`` (11, 4, 4), the world view the identity within
    1e-5; the resumed Trainer's world_mat table equal to the first's; the
    motion Adam count standing still in stage 2; 5 files a stage-1
    visualization, 4 a stage-2 one; launch counters zeroed before the first
    ``train`` and read after the second: per stage-1 step 4 K2 + 1 K1-fwd
    + 1 K1-bwd + 1 K3-fwd + 1 K3-bwd, per stage-2 step 4 K2 + 1 K1-fwd + 1
    K1-bwd, per render chunk (the transition's 11 views x 4 chunks and the
    visualizations) 4 K2 + 1 K1-fwd, no K4-K7. The run stays in ``tmp``
    for the evaluator; returns (launches, cfg, out_dir)."""
    import numpy as np
    import torch
    from copenerf_torch.data.synthetic import make_scene
    from copenerf_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    scene = make_scene(os.path.join(tmp, "scene"), n_frames=TRAINER_FRAMES,
                       h=TRAINER_RES[0], w=TRAINER_RES[1])
    out_dir = os.path.join(tmp, "out")
    cfg, cuts = trainer_config(scene, out_dir)
    stage2 = {"training.start_query_world_epoch": 1,
              "training.pose_refine_epochs": 60,
              "training.refine_from_scratch": False}
    for key, value in stage2.items():
        cfg["training"][key.split(".")[1]] = value
    cuts.update(stage2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    first = Trainer(copy.deepcopy(cfg), verbose=False)
    first.train(max_epochs=2)
    counts_first = adam_counts(first.state)
    second = Trainer(copy.deepcopy(cfg), verbose=False)
    resumed_it = second.it
    second.train(max_epochs=1)
    launches = {c.name: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts_second = adam_counts(second.state)

    n_views = second.train_field.N_imgs
    its = second.it + 1
    stage1_its = n_views
    r = second.image_renderer
    vis_its = [it for it in range(its) if it % 5 == 0]
    vis_chunks = len(vis_its) * render_chunks(
        r, *cfg["training"]["vis_resolution"])
    views_chunks = n_views * render_chunks(r, *TRAINER_RES)
    per_step1 = {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1,
                 "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1}
    per_step2 = {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1}
    per_chunk = {"sdf_value": 4, "rendercore_fwd": 1}
    want = {c.name: per_step1.get(c.name, 0) * stage1_its
            + per_step2.get(c.name, 0) * (its - stage1_its)
            + per_chunk.get(c.name, 0) * (vis_chunks + views_chunks)
            for c in counters}
    vis_files = {int(d.split("_")[0]): len(os.listdir(
        os.path.join(out_dir, "rendering", d)))
        for d in os.listdir(os.path.join(out_dir, "rendering"))
        if d.endswith("_vis")}
    want_files = {it: 5 if it < stage1_its else 4 for it in vis_its}

    logs = os.path.join(out_dir, "logs")
    scalars = [json.loads(ln) for ln in open(os.path.join(logs, "scalars.jsonl"))]
    epoch_loss = {d["step"]: d["value"] for d in scalars
                  if d["tag"] == "loss_epoch/loss"}
    journal = [json.loads(ln) for ln in open(os.path.join(logs, "throughput.jsonl"))]
    epochs = {d["epoch"]: d for d in journal if "epoch" in d}
    refine = refine_pose_epochs(out_dir)
    poses = np.load(os.path.join(out_dir, "models", "refine_pose.npz"))["init_c2w"]
    world_pos = list(second.train_field.i_train).index(second.world_cam_idx)
    table_first = first._world_mat_dev.cpu().numpy()
    table_second = second._world_mat_dev.cpu().numpy()
    summary = first.transition_summary or {}
    prof = first.profile_summary or {}

    # The refinement again on the transition's own inputs (the depths
    # it wrote), with and without the host pose metrics.
    depth_dir = os.path.join(out_dir, "extraction_stage1", "depths")
    depths = np.stack([np.load(os.path.join(depth_dir, f"depth_{int(t):06d}.npz"))["pred"]
                       for t in second.train_field.i_train])
    k33 = second.train_field.K[second.train_field.i_train][:, :3, :3]
    n_refine = len(refine.get("_loss", []))
    ms_metrics = refine_ms_per_epoch(second.train_field.imgs, depths, k33,
                                     n_refine, second.gt_poses)
    ms_plain = refine_ms_per_epoch(second.train_field.imgs, depths, k33,
                                   n_refine)

    phase_s = time.perf_counter() - t_phase
    log("trainer_stage2", cuts=cuts, frames=TRAINER_FRAMES, train_views=n_views,
        iterations=its, stage1_iterations=stage1_its, saved_at_it=first.it,
        resumed_at_it=resumed_it, epoch_loss=epoch_loss, launches=launches,
        expected=want, visualizations=len(vis_its), vis_files=vis_files,
        render_chunks={"visualizations": vis_chunks, "train_views": views_chunks},
        adam_counts={"after_first": counts_first, "after_second": counts_second},
        fell_back=first.pose_refine_fell_back,
        refine_pose_shape=list(poses.shape),
        world_view_max_dev_from_eye=float(np.abs(poses[world_pos] - np.eye(4)).max()),
        tables_equal=bool(np.array_equal(table_first, table_second)),
        phase_s=phase_s)
    log("trainer_stage2_time",
        transition_ms=summary.get("render_train_views_ms", 0.0)
        + summary.get("pose_refine_ms", 0.0),
        render_train_views_ms=summary.get("render_train_views_ms"),
        pose_refine_ms=summary.get("pose_refine_ms"),
        pose_refine_epochs=n_refine,
        pose_refine_ms_per_epoch_in_transition=(
            summary.get("pose_refine_ms", float("nan")) / max(n_refine, 1)),
        pose_refine_ms_per_epoch_with_metrics=ms_metrics,
        pose_refine_ms_per_epoch_without_metrics=ms_plain,
        refine_loss_first_last=[refine["_loss"][0], refine["_loss"][-1]] if n_refine else None,
        refine_ate_first_last=[refine["ate"][0], refine["ate"][-1]] if refine.get("ate") else None,
        stage2_ms_per_it=epochs.get(2, {}).get("ms_per_it"),
        stage2_ms_per_it_steps=epochs.get(2, {}).get("ms_per_it_steps"),
        stage2_vis_ms=epochs.get(2, {}).get("vis_ms"),
        by_epoch={e: {k: d[k] for k in ("ms_per_it", "ms_per_it_steps", "vis_ms")}
                  for e, d in epochs.items()},
        busy_share=prof.get("busy_share"),
        busy_share_outside_vis=prof.get("busy_share_outside"),
        peak_gb=peak_gb,
        note=("epoch 2 is the resumed Trainer's stage-2 epoch (11 iterations, "
              "visualizations at 25 and 30); ms_per_it_steps without them; the "
              "transition's times are host clock around calls that end in host "
              "copies; the profiler window covers iterations 16-20 (stage 2, one "
              "visualization at 20)"))
    losses = [epoch_loss.get(e, float("nan")) for e in range(3)]
    if not np.all(np.isfinite(losses)):
        fail(f"trainer_stage2: non-finite epoch losses {losses}")
    if first.pose_refine_fell_back or not summary or summary.get("fell_back"):
        fail(f"trainer_stage2: the transition fell back {summary}")
    if not (n_refine > 1 and refine["_loss"][-1] < refine["_loss"][0]):
        fail(f"trainer_stage2: the refinement's loss did not fall {refine.get('_loss')}")
    if poses.shape != (n_views, 4, 4) or not np.allclose(poses[world_pos], np.eye(4),
                                                         rtol=0, atol=1e-5):
        fail(f"trainer_stage2: refine_pose.npz {poses.shape}, world view "
             f"{poses[world_pos] if len(poses) > world_pos else None}")
    if not (np.array_equal(table_first, table_second)
            and np.array_equal(np.delete(table_second, world_pos, 0),
                               np.delete(poses, world_pos, 0))
            and np.array_equal(table_second[world_pos], np.eye(4))):
        fail("trainer_stage2: the resumed Trainer's world_mat table is not the saved poses")
    if resumed_it != first.it or first.epoch_it != 1:
        fail(f"trainer_stage2: resumed at it {resumed_it}, saved at {first.it}")
    if not (counts_first == {"opt_fields": 2 * n_views, "opt_motion": stage1_its}
            and counts_second == {"opt_fields": 3 * n_views, "opt_motion": stage1_its}):
        fail(f"trainer_stage2: Adam counts {counts_first}, {counts_second}")
    if vis_files != want_files:
        fail(f"trainer_stage2: visualization files {vis_files} != {want_files}")
    if launches != want:
        fail(f"trainer_stage2 launch counts {launches} != {want}")
    return launches, cfg, out_dir


def phase_pose_refine_shape(seed=0, epochs=6, views=34, res=(712, 1266)):
    """``run_pose_refinement`` at a repo config's stage-2 size:
    configs/Co3D/bench.yaml's 712x1266 (scale 1 from epoch 401), 34
    synthetic views from numpy with ``seed`` (smooth images whose pattern
    moves from view to view, smooth positive depths, NDC intrinsics,
    ground-truth poses along a curve): 33 pairs in batches of 16, 16 and 1.
    A warm-up epoch, then ``epochs`` epochs without and with the host pose
    metrics (host clock: the call ends in a host copy), 3 epochs without
    them under ``torch.profiler`` for the device's busy time and 2 for its
    kernels' self times; peak memory; the default ``pose_refine_epochs``
    2000 projected from both."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from copenerf_torch.training.pose_refinement import run_pose_refinement
    from copenerf_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    m, (h, w) = views, res
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    freq = rng.uniform(0.005, 0.02, size=(3, 2)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
    images = np.empty((m, 3, h, w), np.float32)
    depths = np.empty((m, h, w), np.float32)
    for v in range(m):
        for c in range(3):
            images[v, c] = 0.5 + 0.4 * np.sin(freq[c, 0] * (xs + 4.0 * v)
                                              + freq[c, 1] * ys + phase[c])
        depths[v] = 2.0 + np.sin(0.004 * xs + 0.003 * ys + 0.05 * v)
    focal = 0.8 * w
    k33 = np.tile(np.array([[2 * focal / w, 0, 0], [0, -2 * focal / h, 0],
                            [0, 0, -1]], np.float32), (m, 1, 1))
    gt = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    gt[:, 0, 3] = 0.02 * np.arange(m)
    gt[:, 2, 3] = 0.001 * np.arange(m) ** 2
    gen_s = time.perf_counter() - t_phase

    refine_ms_per_epoch(images, depths, k33, 1)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_plain = refine_ms_per_epoch(images, depths, k33, epochs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_metrics = refine_ms_per_epoch(images, depths, k33, epochs, gt)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, DEVICE) as prof:
            run_pose_refinement(images, depths, k33, epochs=3, device=DEVICE)
    device_ms = prof["device_busy_ms"] / 3
    # Where the device time goes: the kernels of 2 epochs by their time
    # (device events only: an operator's device time repeats its kernels').
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as kp:
        run_pose_refinement(images, depths, k33, epochs=2, device=DEVICE)
    by_kernel = sorted(((e.key[:90], e.self_device_time_total / 2e3)
                        for e in kp.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0),
                       key=lambda kv: -kv[1])
    log("pose_refine_shape", views=m, pairs=m - 1,
        batches=[min(16, m - 1 - i) for i in range(0, m - 1, 16)],
        resolution=[h, w], source="configs/Co3D/bench.yaml (scale 1 from epoch 401)",
        input_gb=(images.nbytes + depths.nbytes) / 1e9, epochs=epochs,
        ms_per_epoch_without_metrics=ms_plain, ms_per_epoch_with_metrics=ms_metrics,
        host_metrics_ms_per_epoch=ms_metrics - ms_plain,
        device_busy_ms_per_epoch=device_ms,
        busy_share_without_metrics=prof["busy_share"],
        top_kernels_ms_per_epoch=dict(by_kernel[:8]),
        kernels_ms_per_epoch=sum(ms for _, ms in by_kernel),
        projected_s_2000_epochs_with_metrics=2000 * ms_metrics / 1e3,
        projected_s_2000_epochs_without_metrics=2000 * ms_plain / 1e3,
        peak_gb=peak_gb, data_gen_s=gen_s, phase_s=time.perf_counter() - t_phase)
    if not (np.isfinite(ms_plain) and np.isfinite(ms_metrics) and device_ms > 0):
        fail(f"pose_refine_shape: times {ms_plain}, {ms_metrics}, {device_ms}")


# ---------------------------------------------------------------------------
# Evaluation: test-time pose optimization, the metrics, the Evaluator
# ---------------------------------------------------------------------------

def phase_eval_pose_card_vs_cpu(fields, checked, train):
    """One test-time pose step (``evaluator.pose_loss``, the fields frozen)
    on the card (kernels) and on the CPU (plain versions): view 1 of whole
    (2, 3) ``r``, ``t`` (non-zero, off exp's Taylor branch) on the train
    phase's image 16, 64 of its rays and their jitter, the pose starting
    from the train batch's camera rotated 0.1 rad about y, at the world
    camera's time. The bounds of ``train_stage2_card_vs_cpu``: the loss and
    l2 within 1e-4 relative + 1e-6 on the main-path nets, 1e-3 + 1e-5 on
    the perturbed ones; the r and t gradients within ||d|| / ||ref|| 1e-3
    and 1e-2; the unsampled view's rows zero; no gradient on a field
    weight."""
    import math

    import torch
    from copenerf_torch.evaluation.evaluator import frozen, pose_loss

    _, rcfg, batch = train
    c, sn = math.cos(0.1), math.sin(0.1)
    rot = torch.tensor([[c, 0, sn, 0], [0, 1, 0, 0], [-sn, 0, c, 0],
                        [0, 0, 0, 1]], device=DEVICE)
    inputs = {
        "init": rot @ batch["world_mat"],
        "image": batch["images_all"][batch["image_idx"]].float() / 255.0,
        "K": batch["K_all"][batch["image_idx"]],
        "idx": batch["ray_idx"][:64], "t_rand": batch["t_rand"][:64],
        "time": batch["world_time_step"],
        "near": torch.full((64, 1), batch["near"], device=DEVICE),
        "far": torch.full((64, 1), batch["far"], device=DEVICE)}
    r0 = [[0.0, 0.0, 0.0], [0.02, -0.03, 0.01]]
    t0 = [[0.0, 0.0, 0.0], [0.01, 0.02, -0.015]]
    for nets, f in (("main", fields), ("perturbed", checked)):
        out = {}
        for side, dev in (("card", DEVICE), ("cpu", "cpu")):
            fd = copy.deepcopy(f).to(dev)
            x = {k: v.to(dev) for k, v in inputs.items()}
            r = torch.tensor(r0, device=dev, requires_grad=True)
            t = torch.tensor(t0, device=dev, requires_grad=True)
            t_start = time.perf_counter()
            with frozen(fd):
                loss, l2 = pose_loss(fd, rcfg, r[1], t[1], x["init"], x["image"],
                                     x["K"], x["idx"], x["time"], x["near"],
                                     x["far"], t_rand=x["t_rand"])
                loss.backward()
            ms = 1e3 * (time.perf_counter() - t_start)
            weight_grads = sum(p.grad is not None for p in fd.parameters())
            out[side] = (loss.item(), l2.item(), r.grad.cpu(), t.grad.cpu(),
                         weight_grads, ms)
        (lc, l2c, rc, tc, wc, ms_c), (lp, l2p, rp, tp, wp, ms_p) = out["card"], out["cpu"]
        g_err = {"r": rel_norm(rc, rp), "t": rel_norm(tc, tp)}
        log("eval_pose_card_vs_cpu", nets=nets, rays=64, loss_card=lc, loss_cpu=lp,
            l2_card=l2c, l2_cpu=l2p, grad_rel_norm=g_err,
            r_grad_cpu=rp[1].tolist(), t_grad_cpu=tp[1].tolist(),
            weight_grads=[wc, wp], card_ms=ms_c, cpu_ms=ms_p)
        rtol, atol = (1e-4, 1e-6) if nets == "main" else (1e-3, 1e-5)
        g_tol = 1e-3 if nets == "main" else 1e-2
        bad = [k for k, (a, b) in {"loss": (lc, lp), "l2": (l2c, l2p)}.items()
               if not abs(a - b) <= rtol * abs(b) + atol]
        bad += [k for k, e in g_err.items() if not e <= g_tol]
        if bad or wc or wp:
            fail(f"eval_pose_card_vs_cpu ({nets} nets): {bad}, weight grads {wc}, {wp}")
        if not (torch.all(rc[0] == 0) and torch.all(tc[0] == 0)
                and rp[1].abs().max() > 0 and tp[1].abs().max() > 0):
            fail(f"eval_pose_card_vs_cpu ({nets} nets): gradient rows {rc}, {tc}")


def random_vgg(rng, dtype):
    """LPIPS weights in the torchvision shapes, He-scaled from ``rng``:
    ``{"stages", "heads"}`` of CPU tensors of ``dtype``."""
    import numpy as np
    import torch
    from copenerf_torch.evaluation import lpips_torch

    params, c_in = {"stages": [], "heads": []}, 3
    for idxs, c_out in zip(lpips_torch._VGG16_STAGES, lpips_torch.STAGE_CHANNELS):
        stage = []
        for _ in idxs:
            stage.append({
                "w": torch.from_numpy(rng.normal(scale=np.sqrt(2.0 / (9 * c_in)),
                                                 size=(c_out, c_in, 3, 3))).to(dtype),
                "b": torch.from_numpy(rng.normal(scale=0.05, size=c_out)).to(dtype)})
            c_in = c_out
        params["stages"].append(stage)
        params["heads"].append(torch.from_numpy(
            np.abs(rng.normal(size=(1, c_out, 1, 1)))).to(dtype))
    return params


def ssim_dense_conv(img1, img2, window_size=11):
    """SSIM whose five moment maps of the C channels go through one dense
    ``F.conv2d`` (5C channels in and out, the window on the diagonal, zeros
    elsewhere: exact in f32), under whatever TF32 setting is in force. A
    dense convolution is cuDNN's (the metric's depthwise form takes
    PyTorch's own kernel), so this is the form of the trap the metrics
    close."""
    import torch
    import torch.nn.functional as F
    from copenerf_torch.evaluation.metrics_image import gaussian_window

    c = img1.shape[0]
    x = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    weight = torch.zeros((5 * c, 5 * c, window_size, window_size)).to(img1)
    win = torch.from_numpy(gaussian_window(window_size)).to(img1)
    for i in range(5 * c):
        weight[i, i] = win
    mu1, mu2, e11, e22, e12 = F.conv2d(x[None], weight,
                                       padding=window_size // 2)[0].split(c)
    s1, s2, s12 = e11 - mu1 ** 2, e22 - mu2 ** 2, e12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                      / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2)))


def phase_metrics_f32(seed=0, res=TRAINER_RES):
    """SSIM and LPIPS (random He-scaled VGG16 and heads from ``seed``) of a
    render-like pair at ``res`` on the card, with cuDNN's TF32 switched on
    for the phase (PyTorch's default; the device phase turned it off) and
    restored after, against float64 on the CPU. Gates: SSIM within 1e-6,
    LPIPS within 1e-5 relative, the caller's flag untouched. Readings: the
    same metrics with their f32 guard removed, and an SSIM whose
    convolutions go through cuDNN (``ssim_dense_conv``), in TF32; CUDA-
    event times of PSNR, SSIM and LPIPS."""
    import contextlib

    import numpy as np
    import torch
    from copenerf_torch.evaluation import lpips_torch
    from copenerf_torch.evaluation import metrics_image as MI

    rng = np.random.default_rng(seed)
    h, w = res
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    a = np.stack([0.5 + 0.3 * np.sin(0.05 * xs + 0.03 * (c + 1) * ys + c)
                  for c in range(3)]) + 0.1 * rng.uniform(-1, 1, (3, h, w))
    a = np.clip(a, 0, 1)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    p64 = random_vgg(rng, torch.float64)
    p32 = {"stages": [[{k: v.float().to(DEVICE) for k, v in layer.items()}
                       for layer in stage] for stage in p64["stages"]],
           "heads": [hd.float().to(DEVICE) for hd in p64["heads"]]}
    a64, b64 = torch.from_numpy(a), torch.from_numpy(b)
    ac, bc = a64.float().to(DEVICE), b64.float().to(DEVICE)

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        s_card = MI.ssim(ac, bc).item()
        l_card = lpips_torch.lpips(p32, ac, bc).item()
        flag_kept = torch.backends.cudnn.allow_tf32 is True
        times = {"psnr_ms": cuda_ms(lambda: MI.psnr(ac, bc), 20),
                 "ssim_ms": cuda_ms(lambda: MI.ssim(ac, bc), 20),
                 "lpips_ms": cuda_ms(lambda: lpips_torch.lpips(p32, ac, bc), 10)}
        # The same metrics without their guard, and SSIM through cuDNN.
        guards = (MI.exact_f32, lpips_torch.exact_f32)
        MI.exact_f32 = lpips_torch.exact_f32 = contextlib.nullcontext
        try:
            raw = {"ssim_unguarded": MI.ssim(ac, bc).item(),
                   "lpips_unguarded": lpips_torch.lpips(p32, ac, bc).item(),
                   "ssim_cudnn_tf32": ssim_dense_conv(ac, bc).item()}
        finally:
            MI.exact_f32, lpips_torch.exact_f32 = guards
        with MI.exact_f32():
            ssim_cudnn_f32 = ssim_dense_conv(ac, bc).item()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    s_ref = MI.ssim(a64, b64).item()
    l_ref = lpips_torch.lpips(p64, a64, b64).item()
    s_err, l_rel = abs(s_card - s_ref), abs(l_card - l_ref) / abs(l_ref)
    log("metrics_f32", resolution=list(res), cudnn_allow_tf32_during_phase=True,
        ssim_card=s_card, ssim_f64=s_ref, ssim_abs_err=s_err,
        lpips_card=l_card, lpips_f64=l_ref, lpips_rel_err=l_rel,
        ssim_gate=1e-6, lpips_rel_gate=1e-5, flag_kept=flag_kept,
        reading_tf32={"ssim_unguarded_abs_err": abs(raw["ssim_unguarded"] - s_ref),
                      "ssim_cudnn_tf32_abs_err": abs(raw["ssim_cudnn_tf32"] - s_ref),
                      "ssim_cudnn_f32_abs_err": abs(ssim_cudnn_f32 - s_ref),
                      "lpips_unguarded_rel_err": abs(raw["lpips_unguarded"] - l_ref)
                      / abs(l_ref)},
        **times)
    if not (s_err <= 1e-6 and l_rel <= 1e-5 and flag_kept
            and torch.backends.cudnn.allow_tf32 == saved):
        fail(f"metrics_f32: ssim err {s_err}, lpips rel err {l_rel}, "
             f"flag kept {flag_kept}")
    return times


EVAL_PER_STEP = {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1}
EVAL_PER_CHUNK = {"sdf_value": 4, "rendercore_fwd": 1}


def run_evaluator(cfg, counters):
    """``Evaluator(cfg).eval()`` with its stages timed (a device sync at
    each end) and the launch counters zeroed before and read after:
    (evaluator, result, stage ms, launches, LPIPS warnings)."""
    import warnings

    import torch
    from copenerf_torch.evaluation.evaluator import Evaluator

    ev = Evaluator(copy.deepcopy(cfg), verbose=False)
    stage_ms = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms[name] = 1e3 * (time.perf_counter() - t0)
            return out
        return run

    for name in ("eval_optimization", "render_eval", "image_eval",
                 "depth_eval", "pose_eval"):
        setattr(ev, name, timed(name, getattr(ev, name)))
    for c in counters:
        c.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = ev.eval()
    launches = {c.name: c.launches for c in counters}
    lpips_warned = any("LPIPS unavailable" in str(w.message) for w in caught)
    return ev, result, stage_ms, launches, lpips_warned


def phase_evaluator(counters, cfg, out_dir):
    """``Evaluator(cfg).eval()`` on ``trainer_stage2``'s run (12 frames at
    270x480, 1 test view, frame 4; the full-width nets; the checkpoint and
    ``refine_pose.npz`` it wrote): ``eval_pose_epoch`` pose steps of 1,024
    rays, then the view rendered (4 chunks), PSNR / SSIM / LPIPS, the 7
    depth metrics, ATE / RPE, ``results.txt`` and the extraction folders.
    Launch counters zeroed before and read after: per pose step 4 K2 + 1
    K1-fwd + 1 K1-bwd, per render chunk 4 K2 + 1 K1-fwd, no K3-K7. Gates:
    finite PSNR, SSIM in [-1, 1], finite ATE, RPE and depth metrics; LPIPS
    NaN with the warning where no weight pack is found (finite where one
    is); the results file and six folders of one file each; the field
    weights unchanged. A second ``Evaluator`` reuses the pose cache: no
    K1-bwd launch, the render's launches only, and the same metrics."""
    import numpy as np
    import torch
    from copenerf_torch.evaluation.evaluator import DEPTH_METRICS, EXTRACTION_DIRS
    from copenerf_torch.evaluation.lpips_torch import default_weight_paths
    from copenerf_torch.training.checkpoints import load_fields

    t_phase = time.perf_counter()
    cfg = copy.deepcopy(cfg)
    cuts = {"eval.eval_pose_epoch": cfg["eval"]["eval_pose_epoch"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev, result, stage_ms, launches, warned = run_evaluator(cfg, counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_test = len(ev.test_field.i_test)
    steps = int(cfg["eval"]["eval_pose_epoch"]) * n_test
    chunks = n_test * render_chunks(ev.image_renderer, ev.h, ev.w)
    want = {c.name: EVAL_PER_STEP.get(c.name, 0) * steps
            + EVAL_PER_CHUNK.get(c.name, 0) * chunks for c in counters}
    saved = dict(load_fields(out_dir, ev.field_cfgs, DEVICE).named_parameters())
    unchanged = all(torch.equal(p, saved[k])
                    for k, p in ev.state["fields"].named_parameters())
    no_grads = all(p.grad is None for p in ev.state["fields"].parameters())
    files = {sub: len(os.listdir(os.path.join(out_dir, "extraction", sub)))
             for sub in EXTRACTION_DIRS}
    has_results = os.path.isfile(os.path.join(out_dir, "results.txt"))
    l2 = ev.eval_l2_trace

    ev2, result2, stage_ms2, launches2, _ = run_evaluator(cfg, counters)
    want2 = {c.name: EVAL_PER_CHUNK.get(c.name, 0) * chunks for c in counters}
    pack = all(default_weight_paths())
    phase_s = time.perf_counter() - t_phase
    log("evaluator", cuts=cuts, test_views=n_test, test_frames=list(map(int, ev.test_field.i_test)),
        pose_steps=steps, render_chunks=chunks, result=result, launches=launches,
        expected=want, lpips_pack_found=pack, lpips_warned=warned,
        extraction_files=files, results_txt=has_results,
        fields_unchanged=unchanged, field_grads_none=no_grads,
        second={"result": result2, "launches": launches2, "expected": want2,
                "l2_trace": None if ev2.eval_l2_trace is None else len(ev2.eval_l2_trace)},
        phase_s=phase_s)
    log("evaluator_time",
        pose_step_ms=stage_ms["eval_optimization"] / max(steps, 1),
        eval_optimization_ms=stage_ms["eval_optimization"],
        render_ms_per_view=stage_ms["render_eval"] / n_test,
        metric_ms={k: stage_ms[k] for k in ("image_eval", "depth_eval", "pose_eval")},
        second_evaluator_ms=stage_ms2, peak_gb=peak_gb,
        l2_first_epoch=float(np.mean(l2[:n_test])), l2_last_epoch=float(np.mean(l2[-n_test:])),
        l2_first_30_steps=float(np.mean(l2[:30])), l2_last_30_steps=float(np.mean(l2[-30:])),
        note=("host clock with a device sync at each stage's ends; pose_step_ms "
              "is eval_optimization over its steps (the cache write included); "
              "image_eval is PSNR + SSIM (+ LPIPS where a pack is found) on the card"))
    bad = []
    if launches != want:
        bad.append(f"launch counts {launches} != {want}")
    if launches2 != want2 or ev2.eval_l2_trace is not None:
        bad.append(f"cache not reused: launches {launches2} != {want2}")
    if not np.isfinite(result["PSNR"]) or not -1 <= result["SSIM"] <= 1:
        bad.append(f"PSNR {result['PSNR']}, SSIM {result['SSIM']}")
    nums = [result[k] for k in ("ate", "rpe_trans", "rpe_rot", *DEPTH_METRICS)
            if k in result]
    if len(nums) != 10 or not np.all(np.isfinite(nums)):
        bad.append(f"pose / depth metrics {nums}")
    if pack != np.isfinite(result["LPIPS"]) or (not pack and not warned):
        bad.append(f"LPIPS {result['LPIPS']}, pack {pack}, warned {warned}")
    if not (has_results and files == {sub: n_test for sub in EXTRACTION_DIRS}):
        bad.append(f"results.txt {has_results}, extraction {files}")
    if not (unchanged and no_grads):
        bad.append(f"field weights unchanged {unchanged}, no grads {no_grads}")
    if not np.all(np.isfinite(l2)) or len(l2) != steps:
        bad.append(f"l2 trace of {len(l2)} values, finite {np.all(np.isfinite(l2))}")
    same = {k: (result[k] == result2[k] or (np.isnan(result[k]) and np.isnan(result2[k])))
            for k in result}
    if not all(same.values()):
        bad.append(f"second Evaluator's metrics differ {same}")
    if bad:
        fail("evaluator: " + "; ".join(bad))
    return launches


KERNELS = {
    "sdf_value": dict(source="copenerf_torch/csrc/sdf_value.cu",
                      replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:450"),
    "rendercore_fwd": dict(
        source="copenerf_torch/csrc/rendercore_fwd.cu",
        replaces="copenerf_tpu/ops/pallas/rendercore_kernels.py:326"),
    "rendercore_bwd": dict(
        source="copenerf_torch/csrc/rendercore_bwd.cu",
        replaces="copenerf_tpu/ops/pallas/rendercore_kernels.py:364"),
    "sdf_value_diff_fwd": dict(
        source="copenerf_torch/csrc/sdf_value.cu",
        replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:472"),
    "sdf_value_bwd": dict(
        source="copenerf_torch/csrc/sdf_value_bwd.cu",
        replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:515"),
    "sdf_outgrad_fwd": dict(
        source="copenerf_torch/csrc/sdf_outgrad_fwd.cu",
        replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:472"),
    "sdf_outgrad_bwd": dict(
        source="copenerf_torch/csrc/sdf_outgrad_bwd.cu",
        replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:515"),
    "color_fwd": dict(
        source="copenerf_torch/csrc/color_fwd.cu",
        replaces="copenerf_tpu/ops/pallas/color_kernels.py:188"),
    "color_bwd": dict(
        source="copenerf_torch/csrc/color_bwd.cu",
        replaces="copenerf_tpu/ops/pallas/color_kernels.py:209"),
    "rendercore_cons_fwd": dict(
        source="copenerf_torch/csrc/rendercore_cons_fwd.cu",
        replaces="copenerf_tpu/ops/pallas/rendercore_kernels.py:326"),
    "rendercore_cons_bwd": dict(
        source="copenerf_torch/csrc/rendercore_cons_bwd.cu",
        replaces="copenerf_tpu/ops/pallas/rendercore_kernels.py:364"),
    "sdf_out_fwd": dict(
        source="copenerf_torch/csrc/sdf_outgrad_fwd.cu",
        replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:472"),
    "sdf_out_bwd": dict(
        source="copenerf_torch/csrc/sdf_value_bwd.cu",
        replaces="copenerf_tpu/ops/pallas/sdf_kernels.py:515"),
}


def print_contract_line():
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    import tempfile

    import torch

    # The port must be beside this script: fail before printing anything.
    sys.path.insert(0, REPO)
    from copenerf_torch.ops.kernels import color as CK
    from copenerf_torch.ops.kernels import outgrad as OG
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import rendercore_cons as RCC
    from copenerf_torch.ops.kernels import sdf_out as SO
    from copenerf_torch.ops.kernels import sdf_value as SV
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

    phase_device()
    phase_build()
    cfg, _, fields, checked = full_width_nets(seed=0)
    ncfg, _, nfields, nchecked = full_width_nets(seed=0, negative_ray=True)
    with torch.no_grad():
        kres = phase_kernels(checked)
    tres, step_ms = phase_train_kernels(checked)
    kres.update(tres)
    cres, cstep_ms = phase_composed_kernels(nchecked)
    kres.update(cres)
    counters = [SV.COUNTER, RC.COUNTER, RC.BWD_COUNTER, SVD.FWD_COUNTER,
                SVD.BWD_COUNTER, OG.FWD_COUNTER, OG.BWD_COUNTER, CK.FWD_COUNTER,
                CK.BWD_COUNTER, RCC.FWD_COUNTER, RCC.BWD_COUNTER, SO.FWD_COUNTER,
                SO.BWD_COUNTER]
    launches = {}
    launches["render"], view = phase_main(
        cfg, fields, counters, {"sdf_value": 4, "rendercore_fwd": 1})
    phase_card_vs_cpu(cfg, fields, checked, view)
    launches["train"], train = phase_train(
        cfg, fields, counters, step_ms,
        {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1,
         "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1})
    phase_train_card_vs_cpu(fields, checked, train)
    phase_train_card_vs_cpu(fields, checked, stage2_setup(cfg, train),
                            phase="train_stage2_card_vs_cpu")
    phase_eval_pose_card_vs_cpu(fields, checked, train)
    # The composed path (use_negative_ray_vector): K4 + K5 in place of K1.
    launches["render_composed"], _ = phase_main(
        ncfg, nfields, counters,
        {"sdf_value": 4, "sdf_outgrad_fwd": 1, "color_fwd": 1}, views=1,
        phase="composed_main")
    launches["train_composed"], ctrain = phase_train(
        ncfg, nfields, counters, {**step_ms, **cstep_ms},
        {"sdf_value": 4, "sdf_outgrad_fwd": 1, "sdf_outgrad_bwd": 1,
         "color_fwd": 1, "color_bwd": 1, "sdf_value_diff_fwd": 1,
         "sdf_value_bwd": 1}, steps=10, window=3, phase="composed_train")
    phase_train_card_vs_cpu(nfields, nchecked, ctrain, phase="composed_card_vs_cpu")

    # The folded consistency query (COPENERF_FOLD_CONS=1, read at call
    # time): K6 in place of K1 + K3, then K7 through fields.sdf_output.
    fres, fstep_ms = phase_fold_kernels(checked)
    kres.update(fres)
    saved = os.environ.get("COPENERF_FOLD_CONS")
    os.environ["COPENERF_FOLD_CONS"] = "1"
    try:
        launches["train_fold"], ftrain = phase_train(
            cfg, fields, counters, {**step_ms, **fstep_ms},
            {"sdf_value": 4, "rendercore_cons_fwd": 1, "rendercore_cons_bwd": 1},
            steps=10, window=3, phase="fold_train")
        phase_train_card_vs_cpu(fields, checked, ftrain, phase="fold_card_vs_cpu",
                                pose_grad=True)
    finally:
        if saved is None:
            os.environ.pop("COPENERF_FOLD_CONS")
        else:
            os.environ["COPENERF_FOLD_CONS"] = saved
    ores, launches["sdf_output"] = phase_out_kernels(checked, counters)
    kres.update(ores)
    phase_metrics_f32()
    launches["trainer"] = phase_trainer(counters)
    # The evaluator reads the stage-2 run: its checkpoint and refined poses.
    with tempfile.TemporaryDirectory() as tmp:
        launches["trainer_stage2"], s2cfg, s2dir = phase_trainer_stage2(counters, tmp)
        launches["evaluate"] = phase_evaluator(counters, s2cfg, s2dir)
    phase_pose_refine_shape()

    rows = []
    for name, meta in KERNELS.items():
        # The time line is the main path's largest shape for each kernel.
        t = kres[name]["times"][0]
        by_path = {path: counts[name] for path, counts in launches.items()}
        rows.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": kres[name]["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "rows": t["rows"], "tc_bound_ms": t["tc_bound_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print_contract_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
