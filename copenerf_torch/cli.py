"""Console entry points of the port (port of ``copenerf_tpu/cli.py``).

    python -m copenerf_torch.cli train <cfg.yaml> [--max-epochs N]
    python -m copenerf_torch.cli eval <cfg.yaml> [--no-store]
    python -m copenerf_torch.cli extract-mesh <cfg.yaml> [--resolution 256]
    python -m copenerf_torch.cli bench [--rays 1024 | --sweep]

or, installed, ``copenerf-torch-{train,eval,extract-mesh,bench}``. Every main
runs on the CUDA device unless ``--device cpu`` is given (without a card the
default raises), and turns TF32 off before it builds anything: the port's
kernels compute in f32 or 3xTF32, and so must the PyTorch around them.

train, eval and bench run data-parallel over the cards of a node, one
process per card:

    torchrun --nproc-per-node N -m copenerf_torch.cli train <cfg.yaml>

Each process takes ``cuda:LOCAL_RANK``; rank 0 alone writes files.
extract-mesh runs in one process (the JAX mesher is not sharded either).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

from .device import resolve_device


def _setup(device: str) -> None:
    """Fail on a missing card before anything is written, and turn TF32
    off before anything is built. ``cuda`` is the process's card
    (``cuda:LOCAL_RANK`` under torchrun)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config_path", type=str, help="Config file path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def train_main(argv=None):
    parser = _parser("Training")
    parser.add_argument("--max-epochs", type=int, default=None)
    args = parser.parse_args(argv)
    _setup(args.device)

    from .config.loader import load_config
    from .parallel import distributed as dist
    from .training.trainer import Trainer, bring_up

    cfg = load_config(args.config_path)
    bring_up(cfg, args.device)
    out_dir = cfg["training"]["out_dir"]
    # Rank 0 copies (the JAX CLI copies from every process); the others
    # wait until the run directory is whole.
    if dist.is_primary():
        os.makedirs(out_dir, exist_ok=True)
        shutil.copy(args.config_path, out_dir)
        if cfg["training"].get("backup_source", True):
            from .utils.backup import backup

            backup(out_dir, args.config_path)
    dist.barrier()
    np.random.seed(cfg["training"]["seed"])
    trainer = Trainer(cfg, device=args.device)
    trainer.train(max_epochs=args.max_epochs)
    trainer.save_checkpoint()


def eval_main(argv=None):
    parser = _parser("Evaluation")
    parser.add_argument("--no-store", action="store_true")
    args = parser.parse_args(argv)
    _setup(args.device)

    from .config.loader import load_config
    from .evaluation.evaluator import Evaluator

    cfg = load_config(args.config_path)
    Evaluator(cfg, device=args.device).eval(store_output=not args.no_store)


def extract_mesh_main(argv=None):
    """Marching mesh of the learned SDF zero level set -> PLY (reference
    capability: ``NeuSRenderer.extract_geometry`` via mcubes, the
    reference's ``model/neus_renderer.py:586-591``)."""
    parser = _parser("Mesh extraction")
    parser.add_argument("--out", type=str, default=None,
                        help="Output .ply path (default: out_dir/mesh.ply)")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--threshold", type=float, default=0.0)
    parser.add_argument("--bound", type=float, default=1.2,
                        help="Half-extent of the symmetric extraction cube")
    parser.add_argument("--time-step", type=float, default=None,
                        help="Query time in [-1, 1] (default: world time)")
    args = parser.parse_args(argv)

    if args.time_step is not None and not -1.0 <= args.time_step <= 1.0:
        parser.error(f"--time-step must be in [-1, 1], got {args.time_step} "
                     "(times are normalized frame indices)")
    from .parallel.distributed import launched_world_size

    if launched_world_size() > 1:
        parser.error("extract-mesh runs in one process; launch it without "
                     "torchrun")
    _setup(args.device)

    from .config.loader import load_config
    from .mesher import marching_cubes
    from .training.trainer import Trainer

    cfg = load_config(args.config_path)
    trainer = Trainer(cfg, device=args.device, verbose=False)
    if not trainer.checkpoint_loaded:
        raise SystemExit(
            f"No checkpoint found under {cfg['training']['out_dir']}/models — "
            "refusing to mesh randomly initialized SDF weights. "
            "Train first or point the config's out_dir at a trained run.")
    b = args.bound
    verts, tris = trainer.extract_geometry(
        bound_min=(-b, -b, -b), bound_max=(b, b, b),
        resolution=args.resolution, threshold=args.threshold,
        time_step=args.time_step)
    out = args.out or os.path.join(cfg["training"]["out_dir"], "mesh.ply")
    marching_cubes.save_ply(out, verts, tris)
    print(f"wrote {out}: {len(verts)} vertices, {len(tris)} faces")


def bench_main(argv=None):
    from .bench import main

    main(argv)


COMMANDS = {"train": train_main, "eval": eval_main,
            "extract-mesh": extract_mesh_main, "bench": bench_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit("usage: python -m copenerf_torch.cli "
                         f"{{{','.join(COMMANDS)}}} [arguments]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
