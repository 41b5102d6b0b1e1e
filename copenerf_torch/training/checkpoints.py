"""Checkpoint reading (read side of ``copenerf_tpu/training/checkpoints.py``).

The JAX package stores its train state as a flat npz of '/'-joined pytree
paths at ``<out_dir>/models/<sub>/model.ckpt.npz`` plus ``meta.json``
scalars. ``load_checkpoint`` rebuilds the nested tree with numpy leaves;
``load_fields`` hands its ``params`` subtree to the weight exchange, so a
JAX-trained run renders in the port. The write side lands with training.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _unflatten(flat: dict):
    # Build a nested dict first, then convert #i / __len__ markers to lists.
    root = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def convert(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node:
            return None
        if "__len__" in node:
            n = int(node["__len__"])
            seq = [convert(node[f"#{i}"]) for i in range(n)]
            return tuple(seq) if "__tuple__" in node else seq
        return {k: convert(v) for k, v in node.items()}

    return convert(root)


def load_checkpoint(out_dir: str, sub: str = "weights",
                    model_only: bool = False):
    """Load (state, scalars) with numpy leaves; raises FileNotFoundError
    when the checkpoint is absent."""
    path = os.path.join(out_dir, "models", sub)
    ckpt = os.path.join(path, "model.ckpt.npz")
    if not os.path.isfile(ckpt):
        raise FileNotFoundError(ckpt)
    with np.load(ckpt) as blob:
        flat = {k: blob[k] for k in blob.files}
    state = _unflatten(flat)
    scalars = {}
    meta = os.path.join(path, "meta.json")
    if os.path.isfile(meta) and not model_only:
        with open(meta) as f:
            scalars = json.load(f)
    return state, scalars


def load_fields(out_dir: str, configs: dict, device="cuda",
                sub: str = "weights"):
    """The port's networks holding a JAX checkpoint's ``params``."""
    from ..models.exchange import params_from_jax

    state, _ = load_checkpoint(out_dir, sub, model_only=True)
    return params_from_jax(state["params"], configs, device)
