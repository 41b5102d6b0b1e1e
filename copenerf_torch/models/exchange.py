"""Weight exchange between the JAX parameter tree and the port's modules.

The JAX package stores a weight-normed layer as
``{"v": (in, out), "g": (out,), "b": (out,)}`` and a plain one as
``{"w": (in, out), "b": (out,)}`` (``copenerf_tpu/models/mlp.py``); the
port's layers keep PyTorch's (out, in) layout, so ``v``/``w`` transpose on the
way across (and the weight-norm axis flips with them). The variance network
is ``{"variance": ()}``. Layer names match one-to-one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .fields import (ColorNetwork, MotionNetwork, NeRF, SDFNetwork,
                     VarianceNetwork)

_NETWORKS = {"sdf": SDFNetwork, "motion": MotionNetwork,
             "color": ColorNetwork, "nerf": NeRF}


def _copy_(param: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.device))


def load_jax_params(fields: nn.ModuleDict, tree: dict) -> nn.ModuleDict:
    """Copy a JAX params tree (numpy leaves) into existing modules."""
    for name, net in fields.items():
        sub = tree[name]
        if isinstance(net, VarianceNetwork):
            _copy_(net.variance, sub["variance"])
            continue
        if set(sub) != set(net.layers.keys()):
            raise ValueError(f"{name}: layers {sorted(sub)} != "
                             f"{sorted(net.layers.keys())}")
        for lname, layer in net.layers.items():
            p = sub[lname]
            if "v" in p:
                _copy_(layer.v, np.asarray(p["v"]).T)
                _copy_(layer.g, p["g"])
            else:
                _copy_(layer.w, np.asarray(p["w"]).T)
            _copy_(layer.b, p["b"])
    return fields


def params_from_jax(tree: dict, configs: dict,
                    device="cuda") -> nn.ModuleDict:
    """Build the port's networks for ``configs`` holding the JAX ``tree``.
    Only the networks present in ``tree`` are built."""
    from ..device import resolve_device

    dev = resolve_device(device)
    nets = {}
    for name in tree:
        if name == "variance":
            nets[name] = VarianceNetwork(configs[name])
        else:
            nets[name] = _NETWORKS[name](configs[name])
    return load_jax_params(nn.ModuleDict(nets).to(dev), tree)


def _numpy(t: torch.Tensor) -> np.ndarray:
    # A copy: on the CPU .numpy() would share the parameter's memory.
    return np.array(t.detach().cpu().numpy())


def params_to_jax(fields: nn.ModuleDict) -> dict:
    """The JAX params tree (numpy f32 leaves, copies) of the port's
    networks."""
    tree = {}
    for name, net in fields.items():
        if isinstance(net, VarianceNetwork):
            tree[name] = {"variance": _numpy(net.variance)}
            continue
        sub = {}
        for lname, layer in net.layers.items():
            if hasattr(layer, "v"):
                sub[lname] = {"v": _numpy(layer.v).T.copy(),
                              "g": _numpy(layer.g), "b": _numpy(layer.b)}
            else:
                sub[lname] = {"w": _numpy(layer.w).T.copy(),
                              "b": _numpy(layer.b)}
        tree[name] = sub
    return tree
