"""Benchmark of the port: full stage-1 train-step throughput on one CUDA card.

    python -m copenerf_torch.bench               # one JSON line
    python -m copenerf_torch.bench --rays 4096   # another batch
    python -m copenerf_torch.bench --sweep       # a table, no JSON line
    torchrun --nproc-per-node N -m copenerf_torch.bench   # N cards

Keeps the contract of the JAX package's ``bench.py``: the full training
iteration (all stage-1 losses, two Adam updates, full-size field networks,
64 + 64 samples a ray) at the reference protocol's 1,024 rays (64 4x4
patches), on 100 random 540x960 images, reported as rays/s. The default
invocation prints ONE JSON line:

  {"metric": "train_rays_per_sec", "value": N, "unit": "rays/s",
   "vs_baseline": N, "rays_per_step": 1024, "baseline": "...",
   "device": "<nvidia-smi name, power limit>", "launches": {...}}

``launches`` counts each kernel's launches over the run (the warm-up steps
included), on rank 0.

Under torchrun the step is the data-parallel one (the JAX ``bench.py``
meshes every device): the global batch of ``--rays`` rays is split over the
ranks, each on its own card, and rank 0 alone prints the line, with
``world_size`` added; the rays/s count every rank's rays (the global batch)
between CUDA events on rank 0, started after a barrier.

On a CUDA device the step runs the port's kernels: four value sweeps (K2),
the render-core forward and backward (K1) and the sdf-consistency query and
its backward (K3). The value is the time of ITERS steps between two CUDA
events after WARMUP steps; ``host_ms_per_step`` is a host clock over the
same steps that ends in a host copy of the loss.

Baseline: the reference publishes no numbers; ``vs_baseline`` is against an
ESTIMATE of the reference on one modern GPU (3,000 rays/s: ~3 it/s at 1,024
rays for eager NeuS with autograd-in-forward and a double backward), the
JAX package's anchor. The JAX package's measured CPU ratio is no figure of
the port and is not printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .ops.kernels.build import COUNTERS as KERNEL_COUNTERS
from .parallel import distributed as dist

BASELINE_RAYS_PER_SEC_GPU_EST = 3000.0
RAYS_DEFAULT = 1024
SWEEP = (1024, 4096, 8192, 16384, 32768)

H, W = 540, 960
N_IMAGES = 100
WARMUP = 3
ITERS = 20


def build(n_points: int, device="cuda", group=None):
    """(step, state, batch, generator) of the stage-1 step at the protocol
    shape: ``configs`` defaults at full width, seed-0 random fields, 100
    random 540x960 images from ``RandomState(0)``; with ``group`` the
    data-parallel step of the global batch ``n_points``."""
    from .config.loader import load_config
    from .device import resolve_device
    from .models.fields import configs_from_cfg, init_all_fields
    from .ops.renderer import RendererConfig
    from .training.step import (StepStatic, build_train_step,
                                init_train_state, make_loss_weights)

    dev = resolve_device(device)
    cfg = load_config(None)
    rcfg = RendererConfig.from_cfg(cfg)
    fields = init_all_fields(configs_from_cfg(cfg),
                             torch.Generator().manual_seed(0), device=dev)
    static = StepStatic(
        h=H, w=W, patch_size=4, n_points=n_points, stage1=True,
        n_images=N_IMAGES, nb_sample_timestep=10, n_ref=3, train_motion=True,
        sdf_cons_pose_grad=False, use_flow_rgb=True, use_sdf_consistency=True)
    step = build_train_step(rcfg, static, group=group)
    state = init_train_state(fields)

    rng = np.random.RandomState(0)
    fx = fy = 600.0
    cam = np.array([[2 * fx / W, 0, 0, 0], [0, -2 * fy / H, 0, 0],
                    [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    batch = {
        "images_all": torch.from_numpy(
            rng.rand(N_IMAGES, 3, H, W).astype(np.float32)).to(dev),
        "K_all": t(np.stack([cam] * N_IMAGES)),
        "ref_idxs": t([51, 52, 53], torch.int64),
        "ref_in_list": t([1.0, 1.0, 1.0]),
        "ref_valid_flow": t([1.0, 1.0, 1.0]),
        "scale_mat": torch.eye(4, device=dev),
        "world_mat": torch.eye(4, device=dev),
        "query_time_step": t(0.0),
        "world_time_step": t(0.0),
        "image_idx": t(50, torch.int64),
        "world_cam_idx": t(49, torch.int64),
        "near": 0.01,
        "far": 5.0,
        "cos_anneal_ratio": 0.5,
        "loss_weights": make_loss_weights(0.33333, 0.1, 0.1, 7.5, 0.0, 1.0,
                                          1e-4),
        "lr": 1e-3,
        "motion_lr": 5e-4,
    }
    generator = torch.Generator(device=dev).manual_seed(0)
    return step, state, batch, generator


def time_step(n_points: int, iters: int, warmup: int):
    """(rays/s from CUDA events, ms a step from the events, ms a step from
    the host clock) over ``iters`` steps after ``warmup``; every rank's
    rays under torchrun."""
    step, state, batch, generator = build(n_points,
                                          group=dist.process_group())
    for _ in range(warmup):
        metrics = step(state, batch, generator)
    metrics["loss"].item()
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        metrics = step(state, batch, generator)
    end.record()
    metrics["loss"].item()   # the steps chain through the state
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    ms = start.elapsed_time(end) / iters
    return n_points / (ms / 1e3), ms, host_ms


def device_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Port train-step benchmark")
    ap.add_argument("--rays", type=int, default=RAYS_DEFAULT,
                    help="rays per step (1024 = strict reference protocol)")
    ap.add_argument("--sweep", action="store_true",
                    help="time 1k/4k/8k/16k/32k batches; prints a table, "
                    "not the JSON line")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize()
    primary = dist.is_primary()

    if args.sweep:
        for n in SWEEP:
            try:
                rays_per_sec, ms, _ = time_step(n, ITERS, WARMUP)
            except torch.OutOfMemoryError as exc:
                if dist.world_size() > 1:
                    raise   # the other ranks would wait in the next step
                msg = str(exc).splitlines()[0][:120]
                print(f"rays_per_step={n:6d}  FAILED: {msg}", flush=True)
                continue
            finally:
                torch.cuda.empty_cache()
            if primary:
                print(f"rays_per_step={n:6d}  {rays_per_sec:10.1f} rays/s  "
                  f"{ms:8.2f} ms/step", flush=True)
        return

    for c in KERNEL_COUNTERS:
        c.launches = 0
    rays_per_sec, ms, host_ms = time_step(args.rays, ITERS, WARMUP)
    if not primary:
        return
    value = round(rays_per_sec, 1)      # vs_baseline from the printed value
    print(json.dumps({
        "metric": "train_rays_per_sec",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": round(value / BASELINE_RAYS_PER_SEC_GPU_EST, 3),
        "rays_per_step": args.rays,
        "baseline": "vs_baseline uses a GPU ESTIMATE of the reference "
                    "(3000 rays/s), not a measurement",
        "ms_per_step": round(ms, 3),
        "host_ms_per_step": round(host_ms, 3),
        "device": device_line(),
        "world_size": dist.world_size(),
        "launches": {c.name: c.launches for c in KERNEL_COUNTERS},
    }), flush=True)


if __name__ == "__main__":
    main()
