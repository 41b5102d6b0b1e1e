#!/usr/bin/env python3
"""The port's whole-pipeline head-to-head on the synthetic scene.

The port (``copenerf_torch``) trains a fabricated scene through both stages
(stage 1, the transition with the depth-warp pose refinement, stage 2) with
its own ``Trainer``, then evaluates it with its own ``Evaluator`` (test-time
pose optimization, NVS PSNR / SSIM / LPIPS, the depth metrics, Sim(3)-aligned
ATE / RPE). The scene, the config and the schedule are those of
``scripts/e2e_headtohead.py`` (whose table is ``PARITY_E2E.md``), kept here
as the port's own copies, so one seed's run is held against the JAX
package's run of the same seed:

    # the port, on the CPU and on the card (writes R/port_<device>.json and,
    # before training, the initial weights in the JAX layout, R/ref_init.npz)
    python3 e2e_port.py --side torch --device cpu --seed 0 --root R0
    python3 e2e_port.py --side torch --device cuda --seed 0 --root R0
    # the JAX package from the same initial weights (R0/results.json "ours";
    # --out outside the repo, its default is PARITY_E2E.md)
    JAX_PLATFORMS=cpu python scripts/e2e_headtohead.py --skip-reference \\
        --seed 0 --root R0 --out R0/jax.md
    # seeds 0, 1, 2 against each other, through the gate below
    python3 e2e_port.py --compare R0 R1 R2 --out PARITY_E2E_PORT.json \\
        --md PARITY_E2E_PORT.md [--example-json E/port_example.json]
    # examples/synthetic_e2e.py's run (12 frames at 96x128, full width)
    python3 e2e_port.py --example --device cuda --root E

One initial point per seed: the port's ``Trainer`` draws its weights on the
host from ``torch.Generator().manual_seed(seed)``, so a seed gives the same
weights on the CPU and on the card; the JAX side loads ``R/ref_init.npz``
and restarts Adam from it. Each side then trains with its own random
stream (the JAX side with seed + 1000). LPIPS uses one seeded random VGG16
and head set on every side (``seeded_lpips_weights``): the column checks
the metric stack, not perceptual quality.

The gate (``gate_rows``), fixed before the first run: seeds 0, 1, 2; each
port column (CPU, card) against the JAX column on its own. A quality
metric's gap |mean_port - mean_JAX| over the seeds is within
max(range_JAX, range_port), a range being max - min over the seeds; a
depth metric's within max(1e-3 |mean_JAX|, the larger range). A bound is the
smallest shift of a port column's mean the gate can see: with three seeds
it is the seeds' own spread, too wide for a small loss of quality.
``smoke_bounds`` adds a per-seed check for one card run: each pose metric
(which follows the shared init more than the random stream) within
``SEED_GAP_FACTOR`` times the largest gap between two sides' runs of one
seed, around JAX's value of that seed.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# scripts/e2e_headtohead.py's schedule: epochs 0..39, stage 2 at 20,
# milestones {6, 16, 26, 36}, lr drops at 10 and 30.
SCHEDULE = {
    "scheduling_start": 6,
    "scheduling_epoch": 34,
    "start_query_world_epoch": 20,
    "freeze_camera_pose_period": 2,
    "end_smooth_epoch": 26,
    "nb_warm_up_it": 30,
    "lr_drop_half_epoch": [10, 30],
    "end_sdf_weight_increase_iteration": 200,
    "end_consistency_weight_increase_iteration": 150,
    "do_refine_pose": True,
    "refine_from_scratch": False,
    "pose_refine_epochs": 80,
    "pose_refine_lr": 1e-3,
    "checkpoint_every": -1,
    "eval_pose_every": 10 ** 6,
    "print_every": 100,
    "depth_bound_update_every_milestones": [0, 0, 0],
    "n_training_points": 128,
    "patch_size": 4,
    "pretrained_sdf_path": None,
    "coarse_to_fine_scheduler": {},
}

# Its small nets. The SDF bias 1.5 puts the init surface near the scene's
# depth, so the refinement's warps see structure within the short schedule.
TINY = {
    "neus_sdf_network": {"d_hidden": 64, "n_layers": 4, "skip_in": [2],
                         "d_out": 33, "bias": 1.5},
    "neus_rendering_network": {"d_feature": 32, "d_hidden": 32,
                               "n_layers": 2},
    "motion_network": {"d_hidden": 32, "n_layers": 2, "skip_in": [1]},
    "neus_nerf": {"D": 2, "W": 32},
    "neus_renderer": {"n_samples": 24, "n_importance": 24,
                      "up_sample_steps": 2},
    "neus_variance_network": {"init_val": 0.55},
    "neus_training": {"neus_anneal_end": 50},
    "rendering": {"depth_range": [0.5, 6.0]},
    "eval": {"eval_pose_epoch": 30, "eval_pose_lr": 1e-3,
             "eval_pose_scheduler_gamma": 0.5},
}

N_FRAMES, RES_H, RES_W = 16, 44, 64

METRIC_ORDER = ["PSNR", "SSIM", "LPIPS", "rpe_trans", "rpe_rot", "ate",
                "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"]
DEPTH = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
DEPTH_REL = 1e-3
# The pose metrics follow the shared init more than each side's random
# stream: a run of one seed is also held within SEED_GAP_FACTOR times the
# largest gap between two sides' runs of one seed.
POSE = ("rpe_trans", "rpe_rot", "ate")
SEED_GAP_FACTOR = 2.0
SEEDS = (0, 1, 2)
SIDES = ("jax", "port_cpu", "port_cuda")

# A micro run of the same pipeline for the tests: 4 frames at 18x24 (a side
# of 16 pixels or more keeps a pixel in LPIPS's fifth VGG16 stage), frame 2
# the test view, 2 epochs with stage 2 at 1, 2 refinement epochs, 1
# eval-pose epoch: ``run_torch(root, seed, device, **MICRO)``.
MICRO = {
    "n_frames": 4, "res": (18, 24), "sample_rate": 4,
    "schedule": dict(SCHEDULE, scheduling_start=0, scheduling_epoch=2,
                     start_query_world_epoch=1, pose_refine_epochs=2),
    "tiny": dict(TINY, eval=dict(TINY["eval"], eval_pose_epoch=1)),
}

# examples/synthetic_e2e.py's run: configs/default.yaml's full-width nets on
# 12 frames at 96x128, 80 epochs (stage 2 from 40).
EXAMPLE_SCENE = {"n_frames": 12, "h": 96, "w": 128}
EXAMPLE_TRAINING = {
    "original_resolution": [96, 128],
    "resolution": [96, 128],
    "vis_resolution": [48, 64],
    "n_training_points": 1024,
    "patch_size": 4,
    "scheduling_start": 60,
    "scheduling_epoch": 20,
    "start_query_world_epoch": 40,
    "end_smooth_epoch": 10000,
    "nb_warm_up_it": 20,
    "pretrained_sdf_path": None,
    "pose_refine_epochs": 25,
    "checkpoint_every": 20,
    "eval_pose_every": 10,
    "print_every": 20,
    "depth_bound_update_every_milestones": [25, 0, 0],
}
EXAMPLE_DEPTH_RANGE = [0.5, 3.5]
EXAMPLE_EVAL_POSE_EPOCH = 15
EXAMPLE_TPU_CLAIM = ("examples/synthetic_e2e.py's docstring, the JAX package "
                     "on a TPU v5e: 'around PSNR ~20 / ATE ~0.08'")


def seeded_lpips_weights():
    """One deterministic VGG16-features + v0.1-head tensor set (numpy
    ``RandomState(1234)``), the one ``scripts/e2e_headtohead.py`` shares."""
    from copenerf_torch.evaluation.lpips_torch import (STAGE_CHANNELS,
                                                       _VGG16_STAGES)

    rng = np.random.RandomState(1234)
    feats, c_in = {}, 3
    for stage, c_out in zip(_VGG16_STAGES, STAGE_CHANNELS):
        for i in stage:
            feats[f"features.{i}.weight"] = (
                rng.randn(c_out, c_in, 3, 3).astype(np.float32) * 0.05)
            feats[f"features.{i}.bias"] = (
                rng.randn(c_out).astype(np.float32) * 0.05)
            c_in = c_out
    heads = {f"lin{k}.model.1.weight":
             np.abs(rng.randn(1, ch, 1, 1)).astype(np.float32)
             for k, ch in enumerate(STAGE_CHANNELS)}
    return feats, heads


@contextlib.contextmanager
def seeded_lpips(root):
    """The seeded LPIPS pack exported under ``root`` and named by
    ``COPENERF_LPIPS_VGG`` / ``_LIN`` for the block; both restored after."""
    from copenerf_torch.evaluation.lpips_export import export

    feats, heads = seeded_lpips_weights()
    pack = os.path.join(root, "lpips_pack")
    os.makedirs(pack, exist_ok=True)
    np.savez(os.path.join(pack, "feats.npz"), **feats)
    np.savez(os.path.join(pack, "heads.npz"), **heads)
    vgg, lin = export(vgg=os.path.join(pack, "feats.npz"),
                      lin=os.path.join(pack, "heads.npz"), out_dir=pack)
    keys = ("COPENERF_LPIPS_VGG", "COPENERF_LPIPS_LIN")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(dict(zip(keys, (vgg, lin))))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_cfg(root, base, name, out_dir, seed=None, schedule=None, tiny=None,
              res=(RES_H, RES_W), sample_rate=8):
    """The scene config ``scripts/e2e_headtohead.py`` writes, at ``res``
    (frames ``sample_rate // 2``, then every ``sample_rate``-th, are the
    test views); returns its path."""
    import yaml

    training = dict(schedule or SCHEDULE, out_dir=out_dir,
                    resolution=list(res), original_resolution=list(res),
                    vis_resolution=[12, 16])
    if seed is not None:
        training["seed"] = int(seed)
    path = os.path.join(root, f"cfg_{os.path.basename(out_dir)}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "dataloading": {
                "path": base, "scene": [name], "resize_factor": None,
                "n_workers": 0, "shuffle": False, "load_gt_depth": True,
                "sample_rate": sample_rate, "crop_size": 0,
            },
            "training": training,
            **(tiny or TINY),
        }, f)
    return path


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def card_line():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def setup_device(device):
    """The device, checked before anything is written (a missing card
    raises), with TF32 off, as the port's command-line mains set it."""
    import torch

    from copenerf_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def write_init(init_path, tree):
    """Write the initial weights ``tree`` (JAX layout) to ``init_path`` and
    return the file's sha256. A file already there with the same bytes is
    left as it is (its time is what ``load_sides`` holds the JAX run's
    against); one with other weights raises (the JAX side may have read
    it)."""
    from copenerf_torch.training.checkpoints import save_pytree

    fresh = init_path + ".new.npz"
    save_pytree(fresh, tree)
    digest = sha256(fresh)
    if not os.path.isfile(init_path):
        os.replace(fresh, init_path)
        return digest
    os.remove(fresh)
    if sha256(init_path) != digest:
        raise RuntimeError(
            f"{init_path} holds other initial weights than this seed's (a "
            "run that read it would not share this run's init); use a fresh "
            "--root")
    return digest


def train_and_eval(cfg, dev, init_path=None, store_output=False,
                   verbose=True):
    """``Trainer(cfg).train()``, its checkpoint, then
    ``Evaluator(cfg).eval()``, timed (a device sync at each end). Where
    ``init_path`` is given, the initial weights are written there in the
    JAX layout before training (``write_init``). Returns the result dict:
    the metrics, ``_iters``, ``_train_wall_s``, ``_eval_wall_s``,
    ``init_sha256``, ``train_views``, ``test_views``, ``peak_gb``."""
    import torch

    from copenerf_torch.evaluation.evaluator import Evaluator
    from copenerf_torch.models.exchange import params_to_jax
    from copenerf_torch.training.trainer import Trainer

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev, verbose=verbose)
    if trainer.checkpoint_loaded:
        raise RuntimeError(
            f"{cfg['training']['out_dir']} holds a checkpoint: the run "
            "would resume instead of starting from the seed's init; use a "
            "fresh --root")
    digest = None
    if init_path is not None:
        digest = write_init(init_path, params_to_jax(trainer.state["fields"]))
    trainer.train()
    trainer.save_checkpoint()
    _sync(dev)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluator = Evaluator(cfg, device=dev, verbose=verbose)
    result = evaluator.eval(store_output=store_output)
    _sync(dev)
    eval_s = time.perf_counter() - t0
    out = {k: float(v) for k, v in result.items()}
    out.update(_iters=trainer.it + 1, _train_wall_s=train_s,
               _eval_wall_s=eval_s, init_sha256=digest,
               train_views=len(trainer.train_field.i_train),
               test_views=len(evaluator.test_field.i_test),
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None))
    return out


def run_torch(root, seed, device="cuda", n_frames=N_FRAMES, res=(RES_H, RES_W),
              schedule=None, tiny=None, sample_rate=8, verbose=True):
    """One seed of the head-to-head through the port on ``device``: the
    scene under ``root``, the initial weights to ``root/ref_init.npz``,
    train, evaluate, and write ``root/port_<device type>.json``.
    ``n_frames``, ``res``, ``schedule``, ``tiny`` and ``sample_rate`` cut
    the run (the tests' micro run); the defaults are the head-to-head's."""
    import torch

    from copenerf_torch.config.loader import load_config
    from copenerf_torch.data.synthetic import make_scene

    dev = setup_device(device)
    os.makedirs(root, exist_ok=True)
    base, name = make_scene(root, n_frames=n_frames, h=res[0], w=res[1],
                            write_depth=True)
    out_dir = os.path.join(root, f"port_{dev.type}_out")
    cfg = load_config(write_cfg(root, base, name, out_dir, seed=seed,
                                schedule=schedule, tiny=tiny, res=res,
                                sample_rate=sample_rate))
    with seeded_lpips(root):
        result = train_and_eval(cfg, dev, os.path.join(root, "ref_init.npz"),
                                verbose=verbose)
    result.update(seed=int(seed), device=dev.type, torch=torch.__version__,
                  card=card_line() if dev.type == "cuda" else None,
                  scene={"n_frames": n_frames, "h": res[0], "w": res[1]})
    with open(os.path.join(root, f"port_{dev.type}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def run_example(root, device="cuda", verbose=True):
    """``examples/synthetic_e2e.py``'s run through the port: 12 frames at
    96x128, configs/default.yaml's full-width nets, 80 epochs, the
    extraction folders written; LPIPS from the seeded pack. Writes
    ``root/port_example.json``."""
    import torch

    from copenerf_torch.config.loader import load_config
    from copenerf_torch.data.synthetic import make_scene

    dev = setup_device(device)
    os.makedirs(root, exist_ok=True)
    path, name = make_scene(root, **EXAMPLE_SCENE)
    cfg = load_config(None)
    cfg["dataloading"].update({"path": path, "scene": [name]})
    cfg["rendering"]["depth_range"] = list(EXAMPLE_DEPTH_RANGE)
    cfg["training"].update(EXAMPLE_TRAINING,
                           out_dir=os.path.join(root, "out"))
    cfg["eval"]["eval_pose_epoch"] = EXAMPLE_EVAL_POSE_EPOCH
    with seeded_lpips(root):
        result = train_and_eval(cfg, dev, store_output=True, verbose=verbose)
    result.update(device=dev.type, torch=torch.__version__,
                  card=card_line() if dev.type == "cuda" else None,
                  scene=dict(EXAMPLE_SCENE), tpu_claim=EXAMPLE_TPU_CLAIM)
    with open(os.path.join(root, "port_example.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


# --------------------------------------------------------------------------
# The comparison and its gate.

def load_sides(root):
    """{side: result dict} of one seed root: ``results.json`` "ours" (the
    JAX side), ``port_cpu.json``, ``port_cuda.json``. Raises ValueError
    where a side is missing, its init hash differs, or a metric is missing
    or not finite.

    The JAX script records no hash: it loads ``ref_init.npz`` when the file
    is there as its run starts, and writes ``cfg_our_out.yaml`` at that
    start. So its init is inferred from the files' times: the config must
    be no older than ``ref_init.npz`` (which the port never rewrites with
    equal weights, nor overwrites with others), and ``results.json`` no
    older than the config; else ValueError."""
    init = os.path.join(root, "ref_init.npz")
    if not os.path.isfile(init):
        raise ValueError(f"{root}: no ref_init.npz, so no shared init")
    want = sha256(init)
    sides = {}
    paths = {"jax": os.path.join(root, "results.json"),
             "port_cpu": os.path.join(root, "port_cpu.json"),
             "port_cuda": os.path.join(root, "port_cuda.json")}
    jax_cfg = os.path.join(root, "cfg_our_out.yaml")
    for side, path in paths.items():
        if not os.path.isfile(path):
            raise ValueError(f"{root}: {os.path.basename(path)} missing")
        with open(path) as f:
            res = json.load(f)
        if side == "jax":
            if "ours" not in res:
                raise ValueError(f"{path}: no 'ours' result")
            if not (os.path.isfile(jax_cfg)
                    and os.path.getmtime(init) <= os.path.getmtime(jax_cfg)
                    <= os.path.getmtime(path)):
                raise ValueError(
                    f"{root}: the JAX run did not start after ref_init.npz "
                    "was written (cfg_our_out.yaml missing or older), so it "
                    "may not have loaded it")
            res = dict(res["ours"], init_sha256=want)
        if res.get("init_sha256") != want:
            raise ValueError(
                f"{path}: init sha256 {res.get('init_sha256')} != "
                f"ref_init.npz's {want}")
        for k in METRIC_ORDER:
            v = res.get(k)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                raise ValueError(f"{path}: metric {k} is {v!r}")
        sides[side] = res
    return sides


def _range(vals):
    return max(vals) - min(vals)


def metric_bound(metric, per_seed, column, centre):
    """The gate's bound for ``metric`` from ``per_seed`` ({side: {metric:
    [value per seed]}}): the larger range over the seeds of the JAX column
    and of ``column`` (None: the JAX column alone); for a depth metric at
    least 1e-3 |centre|."""
    spread = max(_range(per_seed[side][metric])
                 for side in ("jax",) + ((column,) if column else ()))
    if metric in DEPTH:
        return max(DEPTH_REL * abs(centre), spread)
    return spread


def seed_gap_bound(per_seed, metric):
    """The per-seed bound on |port - JAX| for one seed's run:
    SEED_GAP_FACTOR times the largest gap between two sides' values of
    ``metric`` at one seed of ``per_seed``."""
    n_seeds = len(per_seed["jax"][metric])
    return SEED_GAP_FACTOR * max(
        _range([per_seed[side][metric][i] for side in SIDES])
        for i in range(n_seeds))


def gate_rows(per_seed, column):
    """{metric: row} of ``column`` against the JAX column over the seeds of
    ``per_seed`` ({side: {metric: [value per seed]}}): both means, both
    ranges, the gap, its bound and the verdict."""
    rows = {}
    for k in METRIC_ORDER:
        jax_vals, port_vals = per_seed["jax"][k], per_seed[column][k]
        mean_jax = float(np.mean(jax_vals))
        gap = abs(float(np.mean(port_vals)) - mean_jax)
        bound = metric_bound(k, per_seed, column, mean_jax)
        rows[k] = {"mean_jax": mean_jax,
                   "mean_port": float(np.mean(port_vals)),
                   "range_jax": _range(jax_vals),
                   "range_port": _range(port_vals),
                   "gap": gap, "bound": bound, "ok": bool(gap <= bound)}
    return rows


WALLS = ("_iters", "_train_wall_s", "_eval_wall_s")


def compare(roots, out_json, out_md=None, example_json=None):
    """The gate over the seed roots (one per seed, in order). Writes
    ``out_json`` (the per-seed numbers the smoke reads, each column's rows)
    and ``out_md`` (the table); returns True when every row passes."""
    sides = [load_sides(r) for r in roots]
    seeds = [int(s["port_cpu"]["seed"]) for s in sides]
    if any(int(s["port_cuda"]["seed"]) != seed
           for s, seed in zip(sides, seeds)):
        raise ValueError("the CPU and card runs of a root have other seeds")
    per_seed = {side: {k: [s[side][k] for s in sides]
                       for k in METRIC_ORDER + list(WALLS)}
                for side in SIDES}
    columns = {c: gate_rows(per_seed, c) for c in ("port_cpu", "port_cuda")}
    ok = all(r["ok"] for rows in columns.values() for r in rows.values())
    example = None
    if example_json:
        with open(example_json) as f:
            example = json.load(f)
    report = {
        "gate": ("seeds as listed; each port column against the JAX column: "
                 "quality metrics |mean_port - mean_JAX| <= max(range_JAX, "
                 "range_port); depth metrics <= max(1e-3 |mean_JAX|, the "
                 "larger range); a range is max - min over the seeds"),
        "seeds": seeds,
        "init_sha256": {str(seed): s["jax"]["init_sha256"]
                        for seed, s in zip(seeds, sides)},
        "per_seed": per_seed,
        "card": sorted({s["port_cuda"].get("card") or "" for s in sides}),
        "rows": columns,
        "ok": ok,
        "example": example,
    }
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)
    if out_md:
        with open(out_md, "w") as f:
            f.write(markdown(report))
    return ok


def _fmt(v):
    return f"{v:.6g}"


def markdown(report):
    """The table of ``compare``'s report."""
    seeds = report["seeds"]
    ps = report["per_seed"]
    lines = [
        "# PARITY_E2E_PORT — the port against the JAX package, whole "
        "pipeline (synthetic scene)",
        "",
        f"Scene and schedule of `scripts/e2e_headtohead.py`: {N_FRAMES} "
        f"frames at {RES_H}x{RES_W}, "
        f"{SCHEDULE['scheduling_start'] + SCHEDULE['scheduling_epoch']} "
        f"epochs, stage 2 at {SCHEDULE['start_query_world_epoch']}, "
        f"{SCHEDULE['pose_refine_epochs']} refinement epochs, "
        f"{TINY['eval']['eval_pose_epoch']} eval-pose epochs. Seeds "
        f"{', '.join(map(str, seeds))}; each seed's three runs start from "
        "one init (`ref_init.npz`, sha256 in `PARITY_E2E_PORT.json`) and "
        "train on their own random streams. JAX: `scripts/e2e_headtohead.py "
        "--skip-reference` on the CPU; port: `e2e_port.py --side torch` on "
        "the CPU and on the card "
        f"({'; '.join(c for c in report['card'] if c) or 'card not named'}). "
        "LPIPS: one seeded random VGG16 + head set on every side. Table "
        "written by `python3 e2e_port.py --compare`.",
        "",
        f"Gate (fixed before the first run): {report['gate']}.",
        "",
        "What it resolves: a row's bound is the smallest shift of the port "
        "column's mean the gate can see, so it tells a broken pipeline from "
        "a working one, not a small loss of quality (the PSNR bound is the "
        "seeds' own spread). The chip smoke's run of seed 0 is also held, "
        "for each pose metric, within "
        f"{SEED_GAP_FACTOR:g} times the largest gap between two sides' "
        "values of one seed, around JAX's seed 0 (`e2e_port.smoke_bounds`).",
        "",
        "The JAX column's init is inferred, not hashed: "
        "`scripts/e2e_headtohead.py` records no hash. It loads "
        "`ref_init.npz` when the file is there as its run starts, and "
        "`--compare` refuses a root whose JAX config file "
        "(`cfg_our_out.yaml`, written at that start) is older than "
        "`ref_init.npz` or whose `results.json` is older than that config.",
        "",
        "## Per seed",
        "",
        "| metric | " + " | ".join(
            f"seed {s}: JAX / port CPU / port card" for s in seeds) + " |",
        "|---|" + "---|" * len(seeds),
    ]
    for k in METRIC_ORDER + list(WALLS):
        cells = [" / ".join(_fmt(ps[side][k][i]) for side in SIDES)
                 for i in range(len(seeds))]
        label = {"_iters": "train iterations", "_train_wall_s":
                 "train wall (s)", "_eval_wall_s": "eval wall (s)"}.get(k, k)
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    for column, title in (("port_cpu", "port on the CPU"),
                          ("port_cuda", "port on the card")):
        lines += ["", f"## The gate: {title} against JAX on the CPU", "",
                  "| metric | mean JAX | mean port | range JAX | range port "
                  "| gap | bound | verdict |",
                  "|---|---|---|---|---|---|---|---|"]
        for k, r in report["rows"][column].items():
            lines.append(
                f"| {k} | {_fmt(r['mean_jax'])} | {_fmt(r['mean_port'])} | "
                f"{_fmt(r['range_jax'])} | {_fmt(r['range_port'])} | "
                f"{_fmt(r['gap'])} | {_fmt(r['bound'])} | "
                f"{'pass' if r['ok'] else 'FAIL'} |")
    lines += ["", f"Every row passes: {report['ok']}."]
    ex = report.get("example")
    if ex:
        lines += [
            "", "## `examples/synthetic_e2e.py`'s run through the port", "",
            f"`python3 e2e_port.py --example --device {ex['device']}`: "
            f"{ex['scene']['n_frames']} frames at {ex['scene']['h']}x"
            f"{ex['scene']['w']}, configs/default.yaml's full-width nets, "
            f"{ex['_iters']} iterations, on {ex.get('card') or ex['device']}; "
            "LPIPS from the seeded random pack. Quality reference only: "
            f"{ex['tpu_claim']} (a TPU figure, not the port's; its time is "
            "not compared).", "",
            "| " + " | ".join(METRIC_ORDER) + " |",
            "|" + "---|" * len(METRIC_ORDER),
            "| " + " | ".join(_fmt(ex[k]) for k in METRIC_ORDER) + " |", "",
            f"Train wall {ex['_train_wall_s']:.2f} s, eval wall "
            f"{ex['_eval_wall_s']:.2f} s, peak device memory "
            f"{ex['peak_gb']:.3f} GB."]
    return "\n".join(lines) + "\n"


def smoke_bounds(report, seed=0):
    """{metric: (lo, hi)} a card run of ``seed`` must lie within, from a
    committed ``compare`` report: a quality metric within [min_JAX -
    range_JAX, max_JAX + range_JAX] over the seeds; a depth metric within
    the depth bound (``metric_bound`` of the card column) of JAX's
    ``seed``; a pose metric also within ``seed_gap_bound`` of JAX's
    ``seed`` (the tighter of the two)."""
    ps = report["per_seed"]
    i = report["seeds"].index(seed)
    out = {}
    for k in METRIC_ORDER:
        jax_vals = ps["jax"][k]
        if k in DEPTH:
            b = metric_bound(k, ps, "port_cuda", jax_vals[i])
            out[k] = (jax_vals[i] - b, jax_vals[i] + b)
            continue
        b = metric_bound(k, ps, None, None)
        lo, hi = min(jax_vals) - b, max(jax_vals) + b
        if k in POSE:
            g = seed_gap_bound(ps, k)
            lo, hi = max(lo, jax_vals[i] - g), min(hi, jax_vals[i] + g)
        out[k] = (lo, hi)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--side", choices=("torch",),
                      help="run one seed through the port")
    mode.add_argument("--compare", nargs="+", metavar="ROOT",
                      help="seed roots, in seed order")
    mode.add_argument("--example", action="store_true",
                      help="examples/synthetic_e2e.py's run through the port")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", help="the run's directory")
    ap.add_argument("--out", default="PARITY_E2E_PORT.json",
                    help="--compare: the JSON report")
    ap.add_argument("--md", default=None, help="--compare: the table")
    ap.add_argument("--example-json", default=None,
                    help="--compare: an --example run's port_example.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.compare:
        ok = compare(args.compare, args.out, args.md, args.example_json)
        print(json.dumps({"ok": ok, "out": args.out}))
        return 0 if ok else 1
    if not args.root:
        ap.error("--root is required")
    if args.example:
        res = run_example(args.root, args.device)
    else:
        res = run_torch(args.root, args.seed, args.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
