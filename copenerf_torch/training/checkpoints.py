"""Checkpoint IO in the JAX package's layout (port of
``copenerf_tpu/training/checkpoints.py``).

The train state is stored as a flat npz of '/'-joined tree paths at
``<out_dir>/models/<sub>/model.ckpt.npz`` plus ``meta.json`` scalars
(``epoch_it``, ``it``, ``depth_range``): ``weights`` is the latest,
``weights_<epoch>`` the history. Lists and tuples store ``#i`` entries with
a ``__len__`` (and ``__tuple__``) marker, ``None`` a ``__none__`` marker.
``training/step.py`` ``train_state_to_jax`` / ``train_state_from_jax``
convert the port's state to and from the JAX package's tree, so a run
written by either package resumes in the other. ``load_url`` (a network
fetch) is not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
        out[f"{prefix}__len__"] = np.asarray(len(tree))
        if isinstance(tree, tuple):
            out[f"{prefix}__tuple__"] = np.asarray(1)
    elif tree is None:
        out[f"{prefix}__none__"] = np.asarray(1)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


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


def save_checkpoint(out_dir: str, state: dict, scalars: dict,
                    latest: bool = True, epoch: int | None = None):
    """Write a tree with numpy leaves to
    ``<out_dir>/models/weights[_{epoch}]/model.ckpt.npz`` and its scalars to
    ``meta.json`` beside it."""
    sub = "weights" if latest else f"weights_{epoch}"
    path = os.path.join(out_dir, "models", sub)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "model.ckpt.npz"), **_flatten(state))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(scalars, f)
    return os.path.join(path, "model.ckpt.npz")


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


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_pytree(path: str):
    """The tree of an npz written by ``save_pytree``, numpy leaves."""
    with np.load(path) as blob:
        flat = {k: blob[k] for k in blob.files}
    return _unflatten(flat)
