#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``copenerf_torch``) on one card.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, each printed on its own line, any failure exits non-zero:

1. device   card name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build    nvcc builds every kernel in ``copenerf_torch/csrc`` (one process
            per source, in parallel); prints the build time and ptxas usage,
            then (``registers``) the registers and spill bytes of the
            tensor-core kernels: the row kernels K1-K7 (3xTF32 on
            ``wgmma``, ``csrc/wgmma_tile.cuh``) and the weight-gradient
            reduction (``wgmma``, ``csrc/wgrad.cu``), and any ptxas line
            about the wgmma pipeline (``wgmma_warnings``).
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
23. mesh     ``cli.extract_mesh_main([cfg, "--resolution", "256"])`` on
            ``trainer_stage2``'s run: 16,777,216 grid points in 64 batches,
            each one K2 launch (``Trainer.sdf_grid``), then the port's mesher
            and the PLY. Launch counters zeroed before and read after
            (exactly 64 K2, no other kernel); 65,536 of the grid's values
            against the plain version on the CPU (1e-4); at resolution 64 a
            card mesh and a CPU mesh of the same checkpoint
            (``mesh_agreement``: the same grid signs and triangles,
            every vertex within 1e-3 voxel widths or, on an edge
            where the SDF barely changes, within what twice the plain f32
            grid's error against f64 explains there). Prints the mesher's
            path, the mesh's size, the grid query's ms (CUDA events), the
            K2 launches' alone, the marching's, the PLY write's and the
            peak memory. ``python3 chip_smoke.py --mesh-readings`` trains
            the stage-2 run alone and prints the same check at resolutions
            63, 64, 65 and four time steps.
24. cli      the mains through argv in this process, on the card by default:
            ``train_main --max-epochs 1`` on the trainer phase's scene (a
            fresh out_dir; the checkpoint, the config copy and ``backup/``
            without ``_build``), ``extract_mesh_main --resolution 64`` on
            it, and ``eval_main --no-store`` on a copy of the stage-2 run
            without its pose cache, ``eval_pose_epoch`` cut to 30 (K1-bwd
            30 x the test views); each main's ms and launch counts.
25. bench    ``python3 -m copenerf_torch.bench`` in a subprocess: its JSON
            line parsed, the contract's keys, a finite positive
            ``train_rays_per_sec`` at 1,024 rays, its launch counts.
26. dp_nccl1  data parallelism, each rank a process of this script
            (``--dp-worker``) under ``python -m torch.distributed.run
            --standalone``: one rank over NCCL on card 0 runs 10 stage-1
            steps of the train phase's batch through
            ``build_train_step(..., group=...)`` and the single-device step
            from the same weights (parameters within 1e-6 of each tensor's
            largest entry, the tensors not bitwise equal listed); exact
            launches; the gradient bucket's all-reduce timed alone, its
            bytes; the DP step's ms beside the single-device step's.
27. dp_gloo2_one_card  two ranks sharing card 0 over Gloo (NCCL refuses
            two ranks on one card): 5 stage-1 and 5 stage-2 steps, 512 rays
            a rank, against the one-rank step on the global batch (metrics,
            gradients within 1e-5 of each tensor's largest entry or twice
            the one-rank gradient's own move under 6 reorderings of the
            rays that leave the loss unchanged; a planted per-rank-mean
            fault must exceed that bound), exact launches and rows
            a rank, the replicas bitwise equal; a split 180x320 view
            against the one-rank view; a 2-rank ``Trainer.train(max_epochs=2)``
            on the trainer phase's scene against that phase's loss curve
            (bounded by a one-rank Trainer whose batches are reordered), no
            file from rank 1, rank 0's checkpoint resumed in one process.
28. dp_nccl2  the same over NCCL, a card a rank, where the machine has two
            cards or more; otherwise ``{"phase": "dp_nccl2", "run": false}``.
29. pose_refine_shape  ``run_pose_refinement`` at configs/Co3D/bench.yaml's
            stage-2 size (712x1266, 34 synthetic views, 33 pairs in batches
            of 16, 16, 1): ms an epoch without and with the host pose
            metrics, the device's busy ms an epoch, peak memory, and the
            default 2,000 epochs projected. No gate on speed.
30. e2e      the whole pipeline of ``e2e_port.py`` on the card: seed 0 of
            the head-to-head against the JAX package (16 frames at 44x64,
            the small nets, 40 epochs with stage 2 at 20, 80 refinement
            epochs, 30 eval-pose epochs; ``Trainer.train`` then
            ``Evaluator.eval``). Launch counters zeroed before and read
            after (K3-fwd and K3-bwd once per stage-1 iteration, K1-bwd
            once per iteration and per test-time pose step, K2 and K1-fwd
            at least once per iteration, no K4-K7). Gates: the initial
            weights' sha256 equal to the committed seed-0 hash of
            ``PARITY_E2E_PORT.json``; each quality metric (PSNR, SSIM,
            LPIPS, ATE, RPE) within [min_JAX - range_JAX, max_JAX +
            range_JAX] over the committed JAX seeds, each pose metric (ATE,
            RPE) also within ``e2e_port.SEED_GAP_FACTOR`` times the largest
            committed gap between two sides' values of one seed, of JAX
            seed 0, each depth metric within max(1e-3 |JAX seed 0|, the
            larger committed range) of JAX seed 0. Prints the metrics, train
            and eval wall seconds. Then (``e2e_kernels``) the path's kernels
            at its widths (SDF 52->64x4->33, color 32x2; weights perturbed)
            on the rows the run launched them at (``launch_rows``: each
            kernel's three most launched row counts and its largest),
            against their plain versions with the kernels and
            train_kernels phases' gates; their errors join the kernels
            line's ``max_abs_err``.
31. the ``{"kernels": [...]}`` line (launches per path: render, train,
   render_composed, train_composed, train_fold, sdf_output, trainer,
   trainer_stage2, evaluate, mesh, cli, bench, train_dp (rank 0's
   data-parallel steps), render_dp (rank 0's split view), e2e), then the
   contract line ``{"ok": true, "device": {...}}`` last.

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
    """(row kernel ms, reduction ms, every kernel's ms per launch and
    launches recorded) of one call of a backward launcher, which runs each
    of its kernels once, from torch.profiler's device times
    (``kernel_times.kernel_split``); "not measured" where it sees none."""
    from kernel_times import kernel_split

    split = kernel_split(fn, reps)
    if split is None:
        return "not measured", "not measured", "not measured"
    return (sum(v["ms"] for k, v in split.items() if row_kernel in k),
            sum(v["ms"] for k, v in split.items() if k.startswith("wgrad")), split)


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


def full_width_nets(seed, negative_ray=False, cfg_path=None):
    """(cfg, field configs, geometric-init fields, the same fields perturbed
    for the checks) of configs/default.yaml, or of the config file
    ``cfg_path``; ``negative_ray`` sets the color net's
    ``use_negative_ray_vector`` (the composed path), with the same weights."""
    import torch
    from copenerf_torch.config import load_config
    from copenerf_torch.models import configs_from_cfg, init_all_fields
    from copenerf_torch.models.mlp import perturb_

    cfg = load_config(cfg_path or os.path.join(REPO, "configs", "default.yaml"))
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


def merge_errs(errs, new):
    """``errs[k] = max(errs[k], new[k])`` for every kernel of ``new``."""
    for k, e in new.items():
        errs[k] = max(errs.get(k, 0.0), e)


def check_sdf_value(sdf_net, x):
    """K2 on the rows ``x`` against its plain version: 1e-4 absolute."""
    import torch
    from copenerf_torch.ops.kernels import sdf_value as SV

    n = x.shape[0]
    with torch.no_grad():
        v = SV.sdf_value_cuda(sdf_net, x)
        v_ref = SV.sdf_value_plain(sdf_net, x)
    torch.cuda.synchronize()
    e_v = (v - v_ref).abs().max().item()
    tol_v = 1e-4
    log("check", kernel="sdf_value", rows=n, max_abs_err=e_v, tol=tol_v)
    if not e_v <= tol_v:
        fail(f"sdf_value at {n} rows: max abs err {e_v} > {tol_v}")
    return {"sdf_value": e_v}


def check_rendercore_fwd(sdf_net, color_net, x, d):
    """K1-fwd on the rows ``x``, ``d`` against its plain version
    (``check_forward``)."""
    import torch
    from copenerf_torch.ops.kernels import rendercore as RC

    with torch.no_grad():
        got = RC.rendercore_fwd_cuda(sdf_net, color_net, x, d)
        ref = RC.rendercore_fwd_plain(sdf_net, color_net, x, d)
    torch.cuda.synchronize()
    return {"rendercore_fwd": check_forward(
        "rendercore_fwd", ("sdf", "grad", "color"), got, ref, x.shape[0])}


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
        merge_errs(errs, check_sdf_value(sdf_net, x))
        merge_errs(errs, check_rendercore_fwd(sdf_net, color_net, x, d))

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


def check_rendercore_bwd(sdf_net, color_net, x, d, cot_seed):
    """K1-bwd through its autograd.Function on the rows ``x``, ``d`` against
    autograd of the plain version in f32 and f64, for sbar, gbar, cbar alone
    and all three (cotangents from ``cot_seed``; no color cotangent on rows
    with a color ReLU within KINK_MARGIN of its kink), every input and
    parameter gradient (``check_grads``). Returns {kernel: the largest
    |kernel - plain|}."""
    import torch
    from copenerf_torch.ops.kernels import rendercore as RC

    n = x.shape[0]
    sdf64, color64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    params = [*sdf_net.parameters(), *color_net.parameters()]
    params64 = [*sdf64.parameters(), *color64.parameters()]
    names = (["x", "dirs"] + [f"sdf.{k}" for k, _ in sdf_net.named_parameters()]
             + [f"color.{k}" for k, _ in color_net.named_parameters()])
    g = torch.Generator(device=DEVICE).manual_seed(cot_seed)
    full = [torch.randn((n, w), generator=g, device=DEVICE)
            for w in (1, 4, 3)]
    margin = RC.color_relu_margin(sdf64, color64, x.double(), d.double())
    smooth = margin >= KINK_MARGIN
    log("kinks", rows=n, margin=KINK_MARGIN,
        cbar_zeroed_share=1.0 - smooth.float().mean().item())
    full[2] = full[2] * smooth.float()[:, None]
    del margin
    return {"rendercore_bwd": check_channels(
        "rendercore_bwd", n, names,
        lambda a, b: RC.rendercore_fwd(sdf_net, color_net, a, b),
        lambda f64, a, b: RC.rendercore_fwd_plain(
            *((sdf64, color64) if f64 else (sdf_net, color_net)), a, b),
        [x, d], params, params64, full,
        [("sbar", (1, 0, 0)), ("gbar", (0, 1, 0)), ("cbar", (0, 0, 1)),
         ("all", (1, 1, 1))], 32768)}


def check_sdf_value_diff(sdf_net, x, cot_seed):
    """K3 through its autograd.Function on the rows ``x``: the forward
    within 1e-4 of the plain version, every gradient for one cotangent
    (the first draw from ``cot_seed``, as ``check_rendercore_bwd``'s sbar)
    by ``check_grads``. Returns {kernel: largest |kernel - plain|}."""
    import torch
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

    n = x.shape[0]
    sdf64 = copy.deepcopy(sdf_net).double()
    sdf_params = list(sdf_net.parameters())
    xk = x.clone().requires_grad_(True)
    v = SVD.sdf_value_diff(sdf_net, xk)
    with torch.no_grad():
        v_ref = SVD.sdf_value_diff_plain(sdf_net, x)
    e_v = (v.detach() - v_ref).abs().max().item()
    log("check", kernel="sdf_value_diff_fwd", rows=n, max_abs_err=e_v,
        tol=1e-4)
    if not e_v <= 1e-4:
        fail(f"sdf_value_diff_fwd at {n} rows: {e_v} > 1e-4")
    g = torch.Generator(device=DEVICE).manual_seed(cot_seed)
    obar = torch.randn((n, 1), generator=g, device=DEVICE)[:, 0].contiguous()
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
    return {"sdf_value_diff_fwd": e_v, "sdf_value_bwd": e}


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
    scfg, ccfg = sdf_net.cfg, color_net.cfg
    params = [*sdf_net.parameters(), *color_net.parameters()]
    sdf_params = list(sdf_net.parameters())
    errs = {"rendercore_bwd": 0.0, "sdf_value_diff_fwd": 0.0,
            "sdf_value_bwd": 0.0}
    for n in CHECK_ROWS:
        x, d = sample_rows(n, seed=n + 11)
        merge_errs(errs, check_rendercore_bwd(sdf_net, color_net, x, d,
                                              cot_seed=n))
        merge_errs(errs, check_sdf_value_diff(sdf_net, x, cot_seed=n))
        del x, d
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

        pack_reps = 5
        pack_ms = cuda_ms(value_pack, reps=pack_reps)
        pack_split = kernel_split(value_pack, pack_reps)
    log("step_shapes", rows=n, kernel_ms=step_ms, bound_ms=step_bound,
        tc_bound_ms={**step_tc, "rendercore_fwd": tc_bound_ms(
            *k1_work(scfg, ccfg, n, sdf_net, color_net))},
        value_pack_ms=pack_ms,
        value_pack_device_ms=(sum(v["ms"] * v["launches"] for v in pack_split.values())
                              / pack_reps if pack_split else "not measured"))
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
        losses = record_losses(first)
        first.train(max_epochs=2)
        TRAINER_LOSSES[:] = [float(x) for x in losses]
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


MESH_RES = 256            # the CLI's default resolution: 64 K2 launches
MESH_CHECK_RES = 64       # card mesh against CPU mesh
MESH_CHECK_POINTS = 65536
CLI_EVAL_POSE_EPOCH = 30  # the cli phase's cut of eval_pose_epoch (300)


def write_config(cfg, path):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def capture_self(cls, name, store):
    """Wrap ``cls.name`` to keep the instance it runs on in ``store``;
    returns the original for the caller to restore."""
    orig = getattr(cls, name)

    def run(self, *args, **kwargs):
        store[name] = self
        return orig(self, *args, **kwargs)

    setattr(cls, name, run)
    return orig


def mesh_agreement(card, cpu, res, time_step=None):
    """The meshes of one checkpoint at resolution ``res`` through two
    Trainers' ``extract_geometry`` (time_step None: the world camera's),
    ``card`` on the card and ``cpu`` on the CPU, held against each other.

    The mesher puts each vertex on one grid edge (a, b) whose ends lie on
    either side of the level, at the fraction f_a / (f_a - f_b) of it; which
    edges, and the vertices' order, depend on the grid's signs alone. Two
    grids of the same signs that differ by at most d at a and b place the
    vertex at most d / max(|f_b - f_a|) apart along the edge (the larger of
    the two grids' changes; exact for the interpolation), in voxel widths,
    per coordinate. Where the SDF barely changes across a voxel, f32
    rounding alone moves the vertex far. So the grids' signs and the
    triangles must be the same, and each vertex within the larger of 1e-3
    voxel widths and 2 eps / max(|f_b - f_a|) of its counterpart, eps the
    plain f32 grid's largest error against an f64 evaluation of the same
    points: two f32 grids each as accurate as the plain one differ by at
    most 2 eps. Each vertex's edge comes from the mesher itself: on the
    grid of signs alone (-1 inside, 1 outside) it puts every vertex at its
    edge's midpoint, exactly, in the same order. -> a dict of readings;
    ``ok`` the verdict."""
    import numpy as np
    import torch
    from copenerf_torch.mesher import marching_cubes as MC
    from copenerf_torch.ops.kernels.sdf_value import sdf_value_plain
    from copenerf_torch.training import trainer as TT

    grids = []
    sdf_grid = TT.Trainer.sdf_grid

    def keep(self, *args, **kwargs):
        grids.append(sdf_grid(self, *args, **kwargs))
        return grids[-1]

    TT.Trainer.sdf_grid = keep
    try:
        card_v, card_t = card.extract_geometry(resolution=res, time_step=time_step)
        t0 = time.perf_counter()
        cpu_v, cpu_t = cpu.extract_geometry(resolution=res, time_step=time_step)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        TT.Trainer.sdf_grid = sdf_grid
    g_card, g_cpu = (g.astype(np.float64).ravel() for g in grids)
    # The same points (the f32 axes, the f32 time step) in f64 on the CPU.
    t = cpu.world_time_step if time_step is None else time_step
    axes = MC.grid_axes((-1.2,) * 3, (1.2,) * 3, res)
    pts = np.stack([*np.meshgrid(*axes, indexing="ij"),
                    np.full((res,) * 3, t, np.float32)], -1).reshape(-1, 4)
    net64 = copy.deepcopy(cpu.state["fields"]["sdf"]).cpu().double()
    g64 = -torch.cat([sdf_value_plain(net64, p) for p in
                      torch.from_numpy(pts).double().split(65536)]).numpy()
    eps = float(np.abs(g_cpu - g64).max())

    voxel = 2.4 / (res - 1)
    out = {"resolution": res, "time_step": float(t), "card_faces": len(card_t),
           "cpu_faces": len(cpu_t), "card_vertices": len(card_v),
           "cpu_vertices": len(cpu_v), "cpu_f64_err": eps,
           "card_f64_err": float(np.abs(g_card - g64).max()),
           "card_cpu_grid_diff": float(np.abs(g_card - g_cpu).max()),
           "cpu_mesh_ms": cpu_ms}
    inside = grids[1] < 0
    mid, _ = MC.marching_cubes(np.where(inside, -1.0, 1.0).astype(np.float32), 0.0)
    same = (np.array_equal(inside, grids[0] < 0) and card_v.shape == cpu_v.shape
            == mid.shape and np.array_equal(card_t, cpu_t))
    out["same_signs_and_triangles"] = bool(same)
    if not same:
        out["ok"] = False
        return out
    a, b = (np.ravel_multi_index(f(mid).astype(np.int64).T, inside.shape)
            for f in (np.floor, np.ceil))
    err = np.abs(card_v - cpu_v).max(1) / voxel
    change = np.maximum(np.abs(g_cpu[b] - g_cpu[a]), np.abs(g_card[b] - g_card[a]))
    bound = np.maximum(1e-3, 2 * eps / change)
    out.update(max_vertex_err_voxels=float(err.max()),
               flat_vertices=int((bound > 1e-3).sum()),
               largest_bound_voxels=float(bound.max()),
               worst_err_over_bound=float((err / bound).max()),
               ok=bool((err <= bound).all()))
    return out


def mesh_readings():
    """``--mesh-readings``: the ``trainer_stage2`` phase's run, then
    ``mesh_agreement`` at resolutions 63, 64 and 65 and at the world
    camera's time step (the gate's, at 64), -0.5, 0 and 0.5, one line each.
    Readings of the gate beyond its one point, for this checkout's kernels;
    exits 0 whatever they read."""
    import tempfile

    sys.path.insert(0, REPO)
    from copenerf_torch.training import trainer as TT

    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        _, cfg, _ = phase_trainer_stage2(kernel_counters(), tmp)
        card = TT.Trainer(copy.deepcopy(cfg), verbose=False)
        cpu = TT.Trainer(copy.deepcopy(cfg), device="cpu", verbose=False)
        for t in (None, -0.5, 0.0, 0.5):
            for r in (63, 64, 65):
                log("mesh_reading", **mesh_agreement(card, cpu, r, t))
    return 0


def phase_mesh(counters, cfg, tmp):
    """``extract_mesh_main([cfg, "--resolution", "256"])`` on
    ``trainer_stage2``'s run (the CLI's default resolution: 16,777,216 grid
    points, 64 batches of 262,144, each one K2 launch). Launch counters
    zeroed before the call and read after: 64 K2, no other kernel. The
    grid query (CUDA events around ``Trainer.sdf_grid``, its host copy
    included), the marching and the PLY write (host clocks) are timed inside
    the main; the K2 launches alone are 64 x one grid batch timed by CUDA
    events after it. Gates: the launches; 65,536 of the grid's values, from
    a seed, against the plain version on the CPU within K2's forward gate
    (1e-4); at resolution 64 a card mesh and a CPU mesh of the same
    checkpoint that pass ``mesh_agreement``; a non-empty mesh in the
    PLY."""
    import numpy as np
    import torch
    from copenerf_torch import cli
    from copenerf_torch.mesher import marching_cubes as MC
    from copenerf_torch.models.fields import sdf_value_nograd
    from copenerf_torch.ops.kernels import sdf_value as SV
    from copenerf_torch.training import trainer as TT

    t_phase = time.perf_counter()
    cfg_path = write_config(cfg, os.path.join(tmp, "mesh.yaml"))
    ply = os.path.join(cfg["training"]["out_dir"], "mesh.ply")
    seen = {}
    sdf_grid, march, save = TT.Trainer.sdf_grid, MC.marching_cubes, MC.save_ply

    def timed_grid(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        grid = sdf_grid(self, *args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        seen.update(trainer=self, grid=grid, grid_query_ms=start.elapsed_time(end))
        return grid

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            seen[name] = 1e3 * (time.perf_counter() - t0)
            return out
        return run

    TT.Trainer.sdf_grid = timed_grid
    MC.marching_cubes = timed("marching_ms", march)
    MC.save_ply = timed("ply_write_ms", save)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        cli.extract_mesh_main([cfg_path, "--resolution", str(MESH_RES)])
        main_ms = 1e3 * (time.perf_counter() - t0)
        launches = {c.name: c.launches for c in counters}
    finally:
        TT.Trainer.sdf_grid, MC.marching_cubes, MC.save_ply = sdf_grid, march, save
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = MC.last_path
    with open(ply, "rb") as f:
        header = f.read(4096).split(b"end_header\n")[0].decode("ascii")
    n_verts, n_faces = (int(re.search(rf"element {k} (\d+)", header).group(1))
                        for k in ("vertex", "face"))
    batches = -(-MESH_RES ** 3 // TT.MESH_BATCH)
    want = {c.name: batches if c.name == "sdf_value" else 0 for c in counters}

    trainer, grid = seen["trainer"], seen["grid"]
    net = trainer.state["fields"]["sdf"]
    t = trainer.world_time_step
    axes = [torch.from_numpy(a).to(DEVICE)
            for a in MC.grid_axes((-1.2,) * 3, (1.2,) * 3, MESH_RES)]

    def grid_points(flat):
        r = MESH_RES
        return torch.stack([axes[0][flat // (r * r)], axes[1][(flat // r) % r],
                            axes[2][flat % r],
                            torch.full(flat.shape, t, device=flat.device)], -1)

    # The K2 launches alone: one grid batch (the middle one), 64 times.
    start = min(TT.MESH_BATCH * (batches // 2), MESH_RES ** 3 - TT.MESH_BATCH)
    mid = torch.arange(TT.MESH_BATCH, device=DEVICE) + start
    batch_pts = grid_points(mid)
    with torch.no_grad():
        k2_ms = cuda_ms(lambda: SV.sdf_value(net, batch_pts), 20)
    # 65,536 of the main's grid values against the plain version on the CPU.
    flat = torch.from_numpy(np.random.default_rng(0).choice(
        MESH_RES ** 3, MESH_CHECK_POINTS, replace=False)).to(DEVICE)
    cpu_net = copy.deepcopy(net).cpu()
    plain = -sdf_value_nograd(cpu_net, grid_points(flat).cpu()).numpy()
    card = grid.reshape(-1)[flat.cpu().numpy()]
    query_err = float(np.abs(card - plain).max())
    # Resolution 64: the card's mesh against a CPU Trainer's of the same run.
    cpu_trainer = TT.Trainer(copy.deepcopy(cfg), device="cpu", verbose=False)
    check = mesh_agreement(trainer, cpu_trainer, MESH_CHECK_RES)

    log("mesh", resolution=MESH_RES, mesher_path=path, vertices=n_verts,
        faces=n_faces, launches=launches, expected=want,
        grid_query_ms=seen["grid_query_ms"], k2_ms=k2_ms * batches,
        k2_ms_per_launch=k2_ms, marching_ms=seen["marching_ms"],
        ply_write_ms=seen["ply_write_ms"], main_ms=main_ms, peak_gb=peak_gb,
        query_max_abs_err=query_err, query_points=MESH_CHECK_POINTS,
        check_resolution=MESH_CHECK_RES, check=check,
        note=("grid_query_ms: CUDA events around Trainer.sdf_grid (index "
              "arithmetic, 64 K2 launches, the host copy); k2_ms: 64 x one "
              "262,144-point batch timed alone (CUDA events); marching_ms "
              "and ply_write_ms: host clocks inside the main"),
        phase_s=time.perf_counter() - t_phase)
    bad = []
    if launches != want:
        bad.append(f"launch counts {launches} != {want}")
    if not query_err <= 1e-4:
        bad.append(f"grid values {query_err} from the plain version")
    if not check["ok"]:
        bad.append(f"card mesh against CPU mesh: {check}")
    if not (n_verts > 0 and n_faces > 0 and check["card_faces"] > 0):
        bad.append(f"empty mesh: {n_verts} vertices, {n_faces} faces")
    if bad:
        fail("mesh: " + "; ".join(bad))
    return launches


def phase_cli(counters, s2cfg, s2dir, tmp):
    """The mains in this process through argv, on the card by default, each
    timed (host clock, a device sync at its ends) with its launch counts:
    ``train_main --max-epochs 1`` on the trainer phase's scene (the
    ``trainer`` phase's config without visualizations, a fresh out_dir):
    per step 4 K2 + K1-fwd + K1-bwd + K3-fwd + K3-bwd; it
    writes the checkpoint, the config copy and ``backup/`` without
    ``_build``. ``extract_mesh_main --resolution 64`` on that run: 1 K2.
    ``eval_main --no-store`` on a copy of ``trainer_stage2``'s run without
    its pose cache (``model_eval_pose.npz``) or the evaluator phase's
    outputs, ``eval_pose_epoch`` cut to 30: K1-bwd 30 x the test views, no
    extraction folder, ``results.txt`` written."""
    import shutil

    import numpy as np
    import torch
    from copenerf_torch import cli
    from copenerf_torch.evaluation.evaluator import Evaluator
    from copenerf_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    seen, times, launches = {}, {}, {}

    def run(name, main, argv):
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0)
        launches[name] = {c.name: c.launches for c in counters}

    # train_main, then extract_mesh_main on its checkpoint.
    scene = (s2cfg["dataloading"]["path"], s2cfg["dataloading"]["scene"][0])
    out_dir = os.path.join(tmp, "cli_train")
    train_cfg, cuts = trainer_config(scene, out_dir)
    # The trainer phase shows the visualizations; here they would double
    # the main's time.
    train_cfg["training"]["depth_bound_update_every_milestones"] = [0, 0, 0]
    cuts["training.depth_bound_update_every_milestones"] = [0, 0, 0]
    train_path = write_config(train_cfg, os.path.join(tmp, "cli_train.yaml"))
    orig = capture_self(Trainer, "train", seen)
    try:
        run("train", cli.train_main, [train_path, "--max-epochs", "1"])
    finally:
        Trainer.train = orig
    its = seen["train"].it + 1
    per_step = {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1,
                "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1}
    want = {"train": {c.name: per_step.get(c.name, 0) * its for c in counters}}
    backup = os.path.join(out_dir, "backup", "copenerf_torch")
    wrote = {
        "checkpoint": os.path.isfile(os.path.join(out_dir, "models", "weights",
                                                  "model.ckpt.npz")),
        "config_copy": os.path.isfile(os.path.join(out_dir, "cli_train.yaml")),
        "backup_cu": os.path.isfile(os.path.join(backup, "csrc", "rendercore_bwd.cu")),
        "backup_without_build": not os.path.exists(os.path.join(backup, "_build")),
    }
    run("extract_mesh", cli.extract_mesh_main, [train_path, "--resolution", "64"])
    want["extract_mesh"] = {c.name: int(c.name == "sdf_value") for c in counters}
    wrote["mesh"] = os.path.getsize(os.path.join(out_dir, "mesh.ply")) > 0

    # eval_main on a copy of the stage-2 run without its pose cache.
    eval_dir = os.path.join(tmp, "cli_eval")
    shutil.copytree(s2dir, eval_dir, ignore=shutil.ignore_patterns(
        "model_eval_pose.npz", "extraction", "results.txt"))
    eval_cfg = copy.deepcopy(s2cfg)
    eval_cfg["training"]["out_dir"] = eval_dir
    eval_cfg["eval"]["eval_pose_epoch"] = CLI_EVAL_POSE_EPOCH
    eval_path = write_config(eval_cfg, os.path.join(tmp, "cli_eval.yaml"))
    orig = capture_self(Evaluator, "eval", seen)
    try:
        run("eval", cli.eval_main, [eval_path, "--no-store"])
    finally:
        Evaluator.eval = orig
    ev = seen["eval"]
    n_test = len(ev.test_field.i_test)
    steps = CLI_EVAL_POSE_EPOCH * n_test
    chunks = n_test * render_chunks(ev.image_renderer, ev.h, ev.w)
    want["eval"] = {c.name: EVAL_PER_STEP.get(c.name, 0) * steps
                    + EVAL_PER_CHUNK.get(c.name, 0) * chunks for c in counters}
    wrote["eval_results"] = os.path.isfile(os.path.join(eval_dir, "results.txt"))
    wrote["eval_pose_cache"] = os.path.isfile(os.path.join(
        eval_dir, "models", "weights", "model_eval_pose.npz"))
    wrote["eval_no_extraction"] = not os.path.exists(os.path.join(eval_dir, "extraction"))
    results = {}
    with open(os.path.join(eval_dir, "results.txt")) as f:
        for ln in f:
            k, v = ln.split(": ")
            results[k] = float(v)

    log("cli", cuts={"train": cuts, "eval": {"eval.eval_pose_epoch": CLI_EVAL_POSE_EPOCH}},
        train_iterations=its,
        eval_test_views=n_test, eval_pose_steps=steps, eval_render_chunks=chunks,
        main_ms=times, launches=launches, expected=want, wrote=wrote,
        eval_results=results, phase_s=time.perf_counter() - t_phase)
    bad = [f"{k} launches {launches[k]} != {v}" for k, v in want.items()
           if launches[k] != v]
    bad += [k for k, ok in wrote.items() if not ok]
    if not (np.isfinite(results.get("PSNR", np.nan)) and np.isfinite(results.get("ate", np.nan))):
        bad.append(f"eval results {results}")
    if bad:
        fail("cli: " + "; ".join(bad))
    return {name: sum(launches[k][name] for k in launches) for name in launches["train"]}


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "rays_per_step",
              "baseline", "device")


def phase_bench():
    """``python3 -m copenerf_torch.bench`` in a subprocess: its last line
    parsed as JSON, the contract's keys, ``train_rays_per_sec`` finite and
    positive at 1,024 rays, and its launch counts (23 steps of 4 K2 +
    K1-fwd + K1-bwd + K3-fwd + K3-bwd)."""
    import math

    import torch
    from copenerf_torch import bench

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, "-m", "copenerf_torch.bench"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"bench: exit {res.returncode}: {res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    launches = line.get("launches", {})
    steps = bench.WARMUP + bench.ITERS
    want = {"sdf_value": 4 * steps, "rendercore_fwd": steps, "rendercore_bwd": steps,
            "sdf_value_diff_fwd": steps, "sdf_value_bwd": steps}
    log("bench", line=line, stdout_lines=len(lines), phase_s=time.perf_counter() - t_phase)
    bad = [k for k in BENCH_KEYS if k not in line]
    if len(lines) != 1:
        bad.append(f"{len(lines)} lines of output")
    if not (line.get("metric") == "train_rays_per_sec" and line.get("unit") == "rays/s"
            and line.get("rays_per_step") == 1024
            and isinstance(line.get("value"), (int, float))
            and math.isfinite(line["value"]) and line["value"] > 0):
        bad.append(f"line {line}")
    if {k: v for k, v in launches.items() if v} != want:
        bad.append(f"launches {launches} != {want}")
    if bad:
        fail("bench: " + "; ".join(bad))
    return launches

# ---------------------------------------------------------------------------
# Data parallelism: each rank a process of its own, started by torchrun
# ---------------------------------------------------------------------------

DP_TIMEOUT = 900          # seconds a phase's ranks may take; their collectives' bound
DP_NCCL1_STEPS = 10
DP_STEPS = 5              # a stage, in the two-rank phases
DP_METRIC_RTOL = 2e-5
DP_GRAD_RTOL = 1e-5
# Orders of the global batch's rays that leave the loss unchanged, for the
# one-rank step's own summation-order noise (``reordered``), by seed.
DP_REORDERS = range(6)
TRAINER_LOSSES = []       # the trainer phase's first Trainer, by iteration
DP_PER_STEP = {"stage1": {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1,
                          "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1},
               "stage2": {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1}}


def record_losses(trainer):
    """Keep each iteration's loss of ``trainer`` (device tensors, copied by
    the caller after training); returns the list."""
    losses = []
    get_step = trainer._get_step

    def wrapped(stage1, train_motion):
        inner = get_step(stage1, train_motion)

        def step(state, batch, generator):
            metrics = inner(state, batch, generator)
            losses.append(metrics["loss"])
            return metrics

        return step

    trainer._get_step = wrapped
    return losses


def kernel_counters():
    from copenerf_torch.ops.kernels import color as CK
    from copenerf_torch.ops.kernels import outgrad as OG
    from copenerf_torch.ops.kernels import rendercore as RC
    from copenerf_torch.ops.kernels import rendercore_cons as RCC
    from copenerf_torch.ops.kernels import sdf_out as SO
    from copenerf_torch.ops.kernels import sdf_value as SV
    from copenerf_torch.ops.kernels import sdf_value_diff as SVD

    return [SV.COUNTER, RC.COUNTER, RC.BWD_COUNTER, SVD.FWD_COUNTER,
            SVD.BWD_COUNTER, OG.FWD_COUNTER, OG.BWD_COUNTER, CK.FWD_COUNTER,
            CK.BWD_COUNTER, RCC.FWD_COUNTER, RCC.BWD_COUNTER, SO.FWD_COUNTER,
            SO.BWD_COUNTER]


def run_ranks(phase, nproc, work):
    """``nproc`` ranks of this script's ``--dp-worker phase`` under
    ``python -m torch.distributed.run --standalone``, each writing
    ``<phase>_rank<r>.json`` to ``work``; (their results, seconds). A rank's
    failure fails the phase (torchrun stops the others), and so does
    DP_TIMEOUT (every process of the launch is killed)."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", os.path.abspath(__file__),
           "--dp-worker", phase, work]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        fail(f"{phase}: the ranks did not end within {DP_TIMEOUT} s: {out[-3000:]}")
    if proc.returncode != 0:
        fail(f"{phase}: torchrun exit {proc.returncode}: {out[-6000:]}")
    results = []
    for r in range(nproc):
        with open(os.path.join(work, f"{phase}_rank{r}.json")) as f:
            results.append(json.load(f))
    return results, time.perf_counter() - t0


def optimized_params(state, s):
    stepped = ("opt_fields", "opt_motion") if s.train_motion else ("opt_fields",)
    return [p for key in stepped for g in state[key].param_groups for p in g["params"]]


def params_digest(fields):
    """sha256 of every parameter's bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for p in fields.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def reordered(batch, seed):
    """The batch with its injected global rays (whole 4x4 patches,
    row-major within each) in another order that leaves the loss unchanged:
    the patches permuted, and each patch's 16 rays moved by one of the
    square's 8 symmetries (the smoothness terms are symmetric under each),
    drawn from ``seed``."""
    import torch

    n = batch["ray_idx"].shape[0]
    g = torch.Generator().manual_seed(seed)
    grid = torch.arange(16).reshape(4, 4)
    moves = [torch.rot90(grid, k, (0, 1)) for k in range(4)]
    moves += [m.T for m in moves]
    order = torch.randperm(n // 16, generator=g)
    pick = torch.randint(0, 8, (n // 16,), generator=g)
    rows = torch.cat([16 * int(q) + moves[int(d)].reshape(-1)
                      for q, d in zip(order, pick)]).to(batch["ray_idx"].device)
    return dict(batch, ray_idx=batch["ray_idx"][rows], t_rand=batch["t_rand"][rows])


def one_rank_grads(fields, rcfg, s, batch):
    """(metrics, gradients of the optimized parameters) of the single-device
    loss of the global batch at ``fields``' weights (a copy)."""
    from copenerf_torch.training import step as TS

    ref = copy.deepcopy(fields)
    total, metrics = TS.compute_losses(ref, rcfg, s, batch, batch["ray_idx"],
                                       t_rand=batch["t_rand"])
    total.backward()
    nets = TS.FIELD_NETS + (("motion",) if s.train_motion else ())
    return ({k: float(v) for k, v in metrics.items()},
            [p.grad.detach().clone() for k in nets for p in ref[k].parameters()])


def per_rank_mean_grads(fields, rcfg, s, batch, rank, group):
    """The planted fault: each rank's loss as one device would take it on
    its half of the global batch (local means and denominators), the
    gradients of the optimized networks averaged over the two ranks."""
    import dataclasses

    from copenerf_torch.parallel import distributed as dist
    from copenerf_torch.training import step as TS

    ref = copy.deepcopy(fields)
    n = s.n_points // 2
    rows = slice(rank * n, (rank + 1) * n)
    total, _ = TS.compute_losses(ref, rcfg, dataclasses.replace(s, n_points=n),
                                 batch, batch["ray_idx"][rows],
                                 t_rand=batch["t_rand"][rows])
    total.backward()
    nets = TS.FIELD_NETS + (("motion",) if s.train_motion else ())
    params = [p for k in nets for p in ref[k].parameters()]
    dist.all_reduce_grads_(params, group)
    return [p.grad / 2 for p in params]


def check_dp_grads(got, ref, others):
    """Per gradient tensor: |got - ref| over the bound max(DP_GRAD_RTOL x its
    largest entry, 2 x the most the one-rank gradient moves under the
    reorderings ``others``) + 1e-7; (the largest ratio, its index, how many
    tensors needed the reordering term, the 3 largest ratios with their
    index, difference, scale and reordering term)."""
    rows, by_order = [], 0
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = DP_GRAD_RTOL * float(r.abs().max())
        noise = 2 * max(float((o[i] - r).abs().max()) for o in others)
        by_order += noise > scale
        diff = float((g - r).abs().max())
        rows.append((diff / (max(scale, noise) + 1e-7), i, diff, scale, noise))
    rows.sort(reverse=True)
    return rows[0][0], rows[0][1], by_order, rows[:3]


def dp_nccl1_rank(work):
    """One rank over NCCL: DP_NCCL1_STEPS data-parallel stage-1 steps of the
    train phase's batch against the single-device step from the same
    weights; the gradient all-reduce timed alone."""
    import numpy as np
    import torch
    from copenerf_torch.parallel import distributed as dist
    from copenerf_torch.training import step as TS

    counters = kernel_counters()
    group = dist.process_group()
    cfg, _, fields, _ = full_width_nets(seed=0)
    s, rcfg, batch = train_setup(cfg, seed=5)
    tc = cfg["training"]
    runs = {}
    for name, grp in (("single", None), ("dp", group)):
        state = TS.init_train_state(copy.deepcopy(fields))
        step = TS.build_train_step(rcfg, s, group=grp)
        for c in counters:
            c.launches = 0
        losses, times = [], []
        for i in range(DP_NCCL1_STEPS):
            batch["lr"] = tc["learning_rate"] * min(i / tc["nb_warm_up_it"], 1.0)
            t0 = time.perf_counter()
            m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(1e3 * (time.perf_counter() - t0))
        runs[name] = {"state": state, "losses": losses,
                      "mean_step_ms": float(np.mean(times[1:])),
                      "launches": {c.name: c.launches for c in counters}}
    shares, not_bitwise = {}, []
    single = dict(runs["single"]["state"]["fields"].named_parameters())
    for n, p in runs["dp"]["state"]["fields"].named_parameters():
        a = single[n].detach()
        shares[n] = float((p.detach() - a).abs().max() / a.abs().max().clamp_min(1e-30))
        if not torch.equal(p.detach(), a):
            not_bitwise.append(n)
    params = optimized_params(runs["dp"]["state"], s)
    nbytes = dist.all_reduce_grads_(params, group)
    reduce_ms = cuda_ms(lambda: dist.all_reduce_grads_(params, group), 20)
    return {"rays": s.n_points, "steps": DP_NCCL1_STEPS,
            "losses": {k: r["losses"] for k, r in runs.items()},
            "mean_step_ms": {k: r["mean_step_ms"] for k, r in runs.items()},
            "launches": runs["dp"]["launches"],
            "max_param_share": max(shares.values()),
            "worst_param": max(shares, key=shares.get),
            "not_bitwise": not_bitwise, "n_params": len(shares),
            "allreduce_bytes": nbytes, "allreduce_ms": reduce_ms}


def dp_two_ranks_rank(phase, work):
    """One of two ranks: DP_STEPS stage-1 and DP_STEPS stage-2
    data-parallel steps of the train phase's batch (rank 0 computes the
    one-rank step's metrics and gradients of the global batch at each step's
    weights, in its order and in DP_REORDERS); the planted per-rank-mean
    fault's gradients at the first stage-1 step; the launches and rows of
    each step's kernels; a split render against the one-rank render; a
    ``Trainer.train(max_epochs=2)`` of the trainer phase's config on the
    scene in ``work``, rank r writing to its own out_dir."""
    import numpy as np
    import torch
    from copenerf_torch.evaluation.render import ImageRenderer
    from copenerf_torch.ops.kernels import build
    from copenerf_torch.parallel import distributed as dist
    from copenerf_torch.training import step as TS
    from copenerf_torch.training.trainer import Trainer

    counters = kernel_counters()
    group, rank = dist.process_group(), dist.rank()
    cfg, _, fields, _ = full_width_nets(seed=0)
    train = train_setup(cfg, seed=5)
    out = {"rank": rank}
    check_input = build.check_input
    for stage, (s, rcfg, batch) in (("stage1", train),
                                    ("stage2", stage2_setup(cfg, train))):
        state = TS.init_train_state(copy.deepcopy(fields))
        step = TS.build_train_step(rcfg, s, group=group)
        rec = {"launches": [], "rows": [], "metric_rel": [], "grad_worst": [],
               "grad_worst_tensor": [], "tensors_at_order_noise": [], "ms": []}
        names = [f"{k}.{n}" for k in TS.FIELD_NETS + (("motion",) if s.train_motion else ())
                 for n, _ in state["fields"][k].named_parameters()]
        for k in range(DP_STEPS):
            if rank == 0:
                ref_m, ref_g = one_rank_grads(state["fields"], rcfg, s, batch)
                others = [one_rank_grads(state["fields"], rcfg, s,
                                         reordered(batch, seed))[1]
                          for seed in DP_REORDERS]
            if stage == "stage1" and k == 0:
                fault = per_rank_mean_grads(state["fields"], rcfg, s, batch,
                                            rank, group)
                if rank == 0:
                    out["fault_ratio"] = check_dp_grads(fault, ref_g, others)[0]
            rows = []

            def recording(t, name, width):
                rows.append((name, int(t.shape[0])))
                return check_input(t, name, width)

            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            build.check_input = recording
            try:
                t0 = time.perf_counter()
                m = step(state, batch)
                m = {k: float(v) for k, v in m.items()}
                rec["ms"].append(1e3 * (time.perf_counter() - t0))
            finally:
                build.check_input = check_input
            rec["launches"].append({c.name: c.launches for c in counters if c.launches})
            rec["rows"].append(sorted({n for name, n in rows if name == "x"}))
            if rank == 0:
                got = [p.grad for p in optimized_params(state, s)]
                rec["metric_rel"].append(max(
                    abs(m[k] - v) / (abs(v) + 1e-7 / DP_METRIC_RTOL) for k, v in ref_m.items()))
                worst, at, by_order, top = check_dp_grads(got, ref_g, others)
                rec.setdefault("grad_top", []).append(
                    [[names[i], ratio, diff, scale, noise]
                     for ratio, i, diff, scale, noise in top])
                rec["grad_worst"].append(worst)
                rec["grad_worst_tensor"].append(names[at])
                rec["tensors_at_order_noise"].append(by_order)
        rec["params_sha256"] = params_digest(state["fields"])
        out[stage] = rec

    rcfg = train[1]
    eye = np.eye(4, dtype=np.float32)
    frames, w2c = view_poses(fields, seed=3)
    args = (camera(*RES), w2c[0], eye, time_of(frames[0]), RES,
            cfg["rendering"]["depth_range"], 1.0)
    split = ImageRenderer(rcfg, chunk=CHUNK, device=DEVICE, group=group)
    split.render_image(fields, *args)               # warm-up (not counted)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = split.render_image(fields, *args)
    out["render"] = {"ms": 1e3 * (time.perf_counter() - t0),
                     "launches": {c.name: c.launches for c in counters if c.launches}}
    if rank == 0:
        one = ImageRenderer(rcfg, chunk=CHUNK, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = one.render_image(fields, *args)
        out["render"].update(
            one_rank_ms=1e3 * (time.perf_counter() - t0),
            **{f"{k}_max_abs": float(np.abs(got[k] - ref[k]).max())
               for k in ("color", "depth")},
            bitwise=[k for k in ref if np.array_equal(got[k], ref[k])])

    with open(os.path.join(work, "scene.json")) as f:
        scene = json.load(f)
    tcfg, _ = trainer_config(scene, os.path.join(work, f"{phase}_out{rank}"))
    trainer = Trainer(tcfg, verbose=False)
    losses = record_losses(trainer)
    t0 = time.perf_counter()
    trainer.train(max_epochs=2)
    out["trainer"] = {
        "losses": [float(x) for x in losses], "it": trainer.it,
        "s": time.perf_counter() - t0, "fell_back": trainer.pose_refine_fell_back,
        "profiled": trainer.profile_summary is not None,
        "state_sha256": state_digest(trainer.state)}
    return out


def state_digest(state):
    """sha256 of a train state in the JAX layout (weights and both Adams)."""
    import hashlib

    from copenerf_torch.training import step as TS
    from copenerf_torch.training.checkpoints import _flatten

    flat = _flatten(TS.train_state_to_jax(state))
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(flat[k].tobytes())
    return h.hexdigest()


def dp_worker(phase, work):
    """A rank of ``phase`` (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK):
    NCCL for ``dp_nccl1`` and ``dp_nccl2``; Gloo for ``dp_gloo2_one_card``,
    both ranks on card 0 (NCCL refuses two ranks on one card)."""
    import torch

    sys.path.insert(0, REPO)
    from copenerf_torch.parallel import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = "nccl"
    if phase == "dp_gloo2_one_card":
        backend = "gloo"
        os.environ["LOCAL_RANK"] = "0"
    dist.initialize(backend, timeout=DP_TIMEOUT)
    res = dp_nccl1_rank(work) if phase == "dp_nccl1" else dp_two_ranks_rank(phase, work)
    res.update(backend=torch.distributed.get_backend(), world=dist.world_size(),
               device=str(torch.cuda.current_device()))
    with open(os.path.join(work, f"{phase}_rank{dist.rank()}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_dp_nccl1(work):
    """``dp_nccl1``: one rank over NCCL on card 0 (process group, gradient
    bucket all-reduce, barrier: the real path). Gates: the data-parallel
    parameters after DP_NCCL1_STEPS steps within 1e-6 of each tensor's
    largest entry of the single-device step's (at world size 1 the
    all-reduce is an identity: bitwise wherever the DP losses keep the
    single-device order; the others are listed); exact launches."""
    (res,), sec = run_ranks("dp_nccl1", 1, work)
    want = {k: v * DP_NCCL1_STEPS for k, v in DP_PER_STEP["stage1"].items()}
    launches = {k: v for k, v in res["launches"].items() if v}
    log("dp_nccl1", backend=res["backend"], world=res["world"], rays=res["rays"],
        steps=res["steps"], launches=launches, expected=want,
        max_param_share=res["max_param_share"], worst_param=res["worst_param"],
        not_bitwise=res["not_bitwise"], n_param_tensors=res["n_params"],
        losses=res["losses"], mean_step_ms=res["mean_step_ms"],
        train_phase_step_ms=STEP_MEAN_MS.get("train"),
        allreduce_bytes=res["allreduce_bytes"], allreduce_ms=res["allreduce_ms"],
        phase_s=sec)
    if res["backend"] != "nccl" or res["world"] != 1:
        fail(f"dp_nccl1: backend {res['backend']}, world {res['world']}")
    if not res["max_param_share"] <= 1e-6:
        fail(f"dp_nccl1: parameters {res['max_param_share']} of their largest "
             f"entry from the single-device step's ({res['worst_param']})")
    if launches != want:
        fail(f"dp_nccl1 launch counts {launches} != {want}")
    return launches


def rel_curve(got, ref):
    """The largest relative difference of two loss curves (inf when their
    lengths differ)."""
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not ref.size:
        return float("inf")
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def phase_dp_two_ranks(phase, work, cards, order_losses):
    """``dp_gloo2_one_card`` (Gloo, both ranks on card 0) or ``dp_nccl2``
    (NCCL, a card each). Gates, per stage and step: the global metrics
    within DP_METRIC_RTOL of the one-rank step's; each gradient tensor
    within check_dp_grads' bound, which the planted per-rank-mean fault
    must exceed (on this batch the two halves' weight sums and valid-pixel
    counts are nearly equal, so local denominators move the gradients
    little, and the margin is small); exactly DP_PER_STEP launches a rank,
    the
    field queries at 512 rays a rank (K1 and K3 at 65,536 rows); after the
    steps the parameters bitwise equal on both ranks. The split 180x320
    render within 1e-6 of the one-rank render (color, depth). The 2-rank
    Trainer: its loss curve within 3e-4 relative of the trainer phase's
    one-rank Trainer (TRAINER_LOSSES), or within 3x the one-rank curve's own
    move when each batch's patches are merely reordered
    (``order_losses``), if that is more (22 full-width iterations from
    warm-up: Adam's first steps move near-zero gradient entries by about
    lr sign(g), and the runs part from there); no fallback, equal states on both
    ranks, the profiler window on rank 0 only, no file in rank 1's
    out_dir; rank 0's checkpoint resumes in a one-rank Trainer with its
    state. Returns the launches of rank 0's steps and of its render."""
    from copenerf_torch.training.trainer import Trainer

    (r0, r1), sec = run_ranks(phase, 2, work)
    bad = []
    step_launches = {}
    for stage in ("stage1", "stage2"):
        want = DP_PER_STEP[stage]
        for r in (r0, r1):
            if any(lc != want for lc in r[stage]["launches"]):
                bad.append(f"{stage} rank {r['rank']} launches {r[stage]['launches']} != {want}")
            if any(not rows or max(rows) != 512 * 128 or 512 * 64 not in rows
                   for rows in r[stage]["rows"]):
                bad.append(f"{stage} rank {r['rank']} rows {r[stage]['rows']}")
        for lc in r0[stage]["launches"]:
            for k, v in lc.items():
                step_launches[k] = step_launches.get(k, 0) + v
        if max(r0[stage]["metric_rel"]) > DP_METRIC_RTOL:
            bad.append(f"{stage} metrics {r0[stage]['metric_rel']}")
        if stage == "stage1" and not r0["fault_ratio"] > 1:
            bad.append(f"the planted per-rank-mean fault is {r0['fault_ratio']} of "
                       "the gradient bound: the bound does not catch it")
        if max(r0[stage]["grad_worst"]) > 1.0:
            bad.append(f"{stage} gradients {r0[stage]['grad_worst']} "
                       f"{r0[stage]['grad_worst_tensor']}")
        if r0[stage]["params_sha256"] != r1[stage]["params_sha256"]:
            bad.append(f"{stage}: the ranks' parameters differ")
        log(f"{phase}_{stage}", steps=DP_STEPS, rays=1024, rays_per_rank=512,
            launches_per_step=r0[stage]["launches"][-1], rows=r0[stage]["rows"][-1],
            metric_rel=r0[stage]["metric_rel"], grad_worst=r0[stage]["grad_worst"],
            grad_worst_tensor=r0[stage]["grad_worst_tensor"],
            tensors_at_order_noise=r0[stage]["tensors_at_order_noise"],
            grad_top=r0[stage]["grad_top"],
            planted_fault_ratio=r0["fault_ratio"] if stage == "stage1" else None,
            step_ms={f"rank{r['rank']}": r[stage]["ms"] for r in (r0, r1)},
            replicas_equal=r0[stage]["params_sha256"] == r1[stage]["params_sha256"])
    ren = r0["render"]
    log(f"{phase}_render", resolution=list(RES), chunk=CHUNK, ms=ren["ms"],
        one_rank_ms=ren["one_rank_ms"], launches=ren["launches"],
        color_max_abs=ren["color_max_abs"], depth_max_abs=ren["depth_max_abs"],
        bitwise=ren["bitwise"])
    if not (ren["color_max_abs"] <= 1e-6 and ren["depth_max_abs"] <= 1e-6):
        bad.append(f"split render {ren['color_max_abs']}, {ren['depth_max_abs']}")

    t0, t1 = r0["trainer"], r1["trainer"]
    rel = rel_curve(t0["losses"], TRAINER_LOSSES)
    order_rel = rel_curve(order_losses, TRAINER_LOSSES)
    loss_bound = max(3e-4, 3 * order_rel)
    out1 = os.path.join(work, f"{phase}_out1")
    files1 = [os.path.join(d, f) for d, _, fs in os.walk(out1) for f in fs]
    cfg0, _ = trainer_config(json.load(open(os.path.join(work, "scene.json"))),
                             os.path.join(work, f"{phase}_out0"))
    resumed = Trainer(cfg0, verbose=False)
    resumed_equal = state_digest(resumed.state) == t0["state_sha256"]
    log(f"{phase}_trainer", iterations=len(t0["losses"]), loss_rel_to_one_rank=rel,
        reordered_rel_to_one_rank=order_rel, loss_bound=loss_bound,
        losses=t0["losses"], one_rank_losses=TRAINER_LOSSES, seconds=t0["s"],
        fell_back=[t0["fell_back"], t1["fell_back"]],
        profiled=[t0["profiled"], t1["profiled"]],
        replicas_equal=t0["state_sha256"] == t1["state_sha256"],
        rank1_files=len(files1), resumed_it=resumed.it, resumed_equal=resumed_equal)
    if not rel <= loss_bound:
        bad.append(f"trainer loss curve {rel} from the one-rank Trainer's "
                   f"(bound {loss_bound})")
    if t0["fell_back"] or t1["fell_back"]:
        bad.append("trainer: the transition fell back")
    if t0["state_sha256"] != t1["state_sha256"]:
        bad.append("trainer: the ranks' states differ")
    if not (t0["profiled"] and not t1["profiled"]):
        bad.append(f"trainer: profiler windows {t0['profiled']}, {t1['profiled']}")
    if files1:
        bad.append(f"trainer: rank 1 wrote {files1[:5]}")
    if not (resumed_equal and resumed.it == t0["it"] and resumed.checkpoint_loaded):
        bad.append("trainer: rank 0's checkpoint does not resume its state")
    log(phase, cards=cards, backend=r0["backend"], world=r0["world"],
        devices=[r0["device"], r1["device"]], phase_s=sec)
    if bad:
        fail(f"{phase}: " + "; ".join(bad))
    return step_launches, ren["launches"]


def reordered_trainer_losses(work):
    """The trainer phase's one-rank Trainer once more, each iteration's
    global batch (the same rays and jitter, drawn from the generator as the
    step draws them) with its two halves of patches swapped: how far f32
    summation order alone moves the loss curve (the 2-rank Trainer's
    yardstick)."""
    import dataclasses

    import torch
    from copenerf_torch.training import step as TS
    from copenerf_torch.training import trainer as TT

    def swapped_step(rcfg, static, group=None):
        inner = TS.build_train_step(
            rcfg, dataclasses.replace(static, inject_sampling=True))
        n_uniform = rcfg.n_samples + (0 if static.use_importance else rcfg.n_importance)

        def step(state, batch, generator=None):
            dev = batch["images_all"].device
            ray_idx = TS.sample_patch_indices(generator, static.h, static.w,
                                              static.patch_size, static.n_points,
                                              device=dev)
            t_rand = torch.rand((static.n_points, n_uniform), generator=generator,
                                device=dev)
            rows = torch.arange(static.n_points, device=dev).roll(static.n_points // 2)
            return inner(state, dict(batch, ray_idx=ray_idx[rows], t_rand=t_rand[rows]))

        return step

    with open(os.path.join(work, "scene.json")) as f:
        scene = json.load(f)
    cfg, _ = trainer_config(scene, os.path.join(work, "reordered"))
    saved = TT.build_train_step
    TT.build_train_step = swapped_step
    try:
        trainer = TT.Trainer(cfg, verbose=False)
        losses = record_losses(trainer)
        trainer.train(max_epochs=2)
    finally:
        TT.build_train_step = saved
    return [float(x) for x in losses]


def phase_dp(tmp):
    """The data-parallel phases: ``dp_nccl1``, ``dp_gloo2_one_card``, and
    ``dp_nccl2`` where the machine has two cards or more. Returns the
    launches of the paths ``train_dp`` (rank 0's DP steps) and
    ``render_dp`` (rank 0's split render)."""
    import torch
    from copenerf_torch.data.synthetic import make_scene

    work = os.path.join(tmp, "dp")
    os.makedirs(work)
    scene = make_scene(os.path.join(work, "scene"), n_frames=TRAINER_FRAMES,
                       h=TRAINER_RES[0], w=TRAINER_RES[1])
    with open(os.path.join(work, "scene.json"), "w") as f:
        json.dump(list(scene), f)
    train = phase_dp_nccl1(work)
    t0 = time.perf_counter()
    order = reordered_trainer_losses(work)
    log("dp_order_yardstick", losses=order, seconds=time.perf_counter() - t0,
        loss_rel_to_one_rank=rel_curve(order, TRAINER_LOSSES))
    gloo_steps, render = phase_dp_two_ranks("dp_gloo2_one_card", work, 1, order)
    for k, v in gloo_steps.items():
        train[k] = train.get(k, 0) + v
    cards = torch.cuda.device_count()
    if cards >= 2:
        nccl_steps, _ = phase_dp_two_ranks("dp_nccl2", work, cards, order)
        for k, v in nccl_steps.items():
            train[k] = train.get(k, 0) + v
    else:
        log("dp_nccl2", run=False, cards=cards)
    return train, render


class launch_rows:
    """Within the block, the row counts each kernel was launched at, and the
    rows of its first launch at each count: ``rows[name][n] = [launches,
    x]``. Every launcher hands its row tensor to ``build.stream`` just
    before it adds one to its counter, so the counter that moved between two
    such calls launched on the earlier call's rows."""

    def __init__(self, counters):
        self.counters, self.rows = counters, {}

    def __enter__(self):
        from copenerf_torch.ops.kernels import build

        self.build, self.stream = build, build.stream
        self.last, self.seen = None, [c.launches for c in self.counters]
        build.stream = self._stream
        return self.rows

    def _settle(self):
        now = [c.launches for c in self.counters]
        for c, before, after in zip(self.counters, self.seen, now):
            if after != before and self.last is not None:
                entry = self.rows.setdefault(c.name, {}).setdefault(
                    self.last.shape[0], [0, self.last.detach().clone()])
                entry[0] += after - before
        self.seen = now

    def _stream(self, t):
        self._settle()
        self.last = t
        return self.stream(t)

    def __exit__(self, *exc):
        self._settle()
        self.build.stream = self.stream
        self.last = None


E2E_CHECKED_COUNTS = 3    # a kernel's most launched row counts checked


def checked_counts(by_count):
    """Of ``launch_rows``' {rows: [launches, x]} for one kernel, the row
    counts the e2e phase checks: the E2E_CHECKED_COUNTS most launched, and
    the largest."""
    top = sorted(by_count, key=lambda n: -by_count[n][0])
    return sorted(set(top[:E2E_CHECKED_COUNTS]) | {max(by_count)})


def phase_e2e(counters, tmp):
    """``e2e_port.run_torch`` for seed 0 on the card, held against the JAX
    seed band committed in ``PARITY_E2E_PORT.json`` (the chip machine has
    no JAX); then the path's kernels at its widths and row counts against
    their plain versions; see the module docstring. Returns the path's
    launches and each kernel's largest error."""
    import torch

    import e2e_port

    with open(os.path.join(REPO, "PARITY_E2E_PORT.json")) as f:
        report = json.load(f)
    root = os.path.join(tmp, "e2e")
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with launch_rows(counters) as rows:
        res = e2e_port.run_torch(root, 0, DEVICE, verbose=False)
    seconds = time.perf_counter() - t0
    launches = {c.name: c.launches for c in counters}
    iters = res["_iters"]
    stage1 = (e2e_port.SCHEDULE["start_query_world_epoch"]
              * res["train_views"])
    pose_steps = (e2e_port.TINY["eval"]["eval_pose_epoch"]
                  * res["test_views"])
    exact = {"sdf_value_diff_fwd": stage1, "sdf_value_bwd": stage1,
             "rendercore_bwd": iters + pose_steps}
    at_least = {"sdf_value": iters + pose_steps,
                "rendercore_fwd": iters + pose_steps}
    bounds = e2e_port.smoke_bounds(report, 0)
    want_hash = report["init_sha256"]["0"]
    log("e2e", seconds=seconds, train_wall_s=res["_train_wall_s"],
        eval_wall_s=res["_eval_wall_s"], iters=iters,
        train_views=res["train_views"], test_views=res["test_views"],
        metrics={k: res[k] for k in e2e_port.METRIC_ORDER},
        bounds=bounds, init_sha256=res["init_sha256"],
        committed_sha256=want_hash, launches=launches, exact=exact,
        at_least=at_least, peak_gb=res["peak_gb"], card=res["card"],
        launch_rows={k: {n: v[0] for n, v in r.items()}
                     for k, r in rows.items()})
    bad = []
    if res["init_sha256"] != want_hash:
        bad.append(f"init sha256 {res['init_sha256']} != committed {want_hash}")
    outside = {k: (res[k], lo, hi) for k, (lo, hi) in bounds.items()
               if not lo <= res[k] <= hi}
    if outside:
        bad.append(f"metrics outside their bounds (value, lo, hi): {outside}")
    for name, n in exact.items():
        if launches[name] != n:
            bad.append(f"{name} launched {launches[name]} times, want {n}")
    for name, n in at_least.items():
        if launches[name] < n:
            bad.append(f"{name} launched {launches[name]} times, want >= {n}")
    others = {k: v for k, v in launches.items()
              if k not in exact and k not in at_least and v}
    if others:
        bad.append(f"kernels off the path launched: {others}")
    if set(rows) != {k for k, v in launches.items() if v}:
        bad.append(f"launch rows recorded for {sorted(rows)}, launched "
                   f"{sorted(k for k, v in launches.items() if v)}")
    elif set(rows["sdf_value_bwd"]) != set(rows["sdf_value_diff_fwd"]):
        bad.append("K3-bwd launched at other row counts than K3-fwd: "
                   f"{sorted(rows['sdf_value_bwd'])}, "
                   f"{sorted(rows['sdf_value_diff_fwd'])}")
    if bad:
        fail("e2e: " + "; ".join(bad))

    # The path's kernels at its widths (the run's config file, weights
    # perturbed as in the kernels phase), on the rows the path launched them
    # at (``checked_counts``; K3-bwd with K3-fwd, on the rows it saved),
    # against their plain versions with the kernels and train_kernels
    # phases' gates.
    _, _, _, checked = full_width_nets(
        0, cfg_path=os.path.join(root, "cfg_port_cuda_out.yaml"))
    sdf_net, color_net = checked["sdf"], checked["color"]
    log("e2e_kernels", sdf_dims=list(sdf_net.cfg.dims),
        color_dims=list(color_net.cfg.dims),
        checked_counts=E2E_CHECKED_COUNTS)
    errs = {}
    checks = {
        "sdf_value": lambda x, d, n: check_sdf_value(sdf_net, x),
        "rendercore_fwd": lambda x, d, n: check_rendercore_fwd(
            sdf_net, color_net, x, d),
        "rendercore_bwd": lambda x, d, n: check_rendercore_bwd(
            sdf_net, color_net, x, d, cot_seed=n),
        "sdf_value_diff_fwd": lambda x, d, n: check_sdf_value_diff(
            sdf_net, x, cot_seed=n),
    }
    counts = {}
    for name, check in checks.items():
        counts[name] = checked_counts(rows[name])
        for n in counts[name]:
            _, d = sample_rows(n, seed=n + 13)
            merge_errs(errs, check(rows[name][n][1], d, n))
    missing = (set(checks) | {"sdf_value_bwd"}) - set(errs)
    if missing:
        fail(f"e2e: path kernels not checked: {sorted(missing)}")
    log("e2e_kernels", rows_checked=counts, max_abs_err=errs)
    torch.cuda.empty_cache()
    return launches, errs


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
    counters = kernel_counters()

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
        launches["mesh"] = phase_mesh(counters, s2cfg, tmp)
        launches["cli"] = phase_cli(counters, s2cfg, s2dir, tmp)
    launches["bench"] = phase_bench()
    with tempfile.TemporaryDirectory() as tmp:
        launches["train_dp"], launches["render_dp"] = phase_dp(tmp)
    phase_pose_refine_shape()
    with tempfile.TemporaryDirectory() as tmp:
        launches["e2e"], e2e_errs = phase_e2e(counters, tmp)
    for name, e in e2e_errs.items():
        kres[name]["max_abs_err"] = max(kres[name]["max_abs_err"], e)

    rows = []
    for name, meta in KERNELS.items():
        # The time line is the main path's largest shape for each kernel.
        t = kres[name]["times"][0]
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
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
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(*sys.argv[2:4]))
    if sys.argv[1:] == ["--mesh-readings"]:
        sys.exit(mesh_readings())
    sys.exit(main())
