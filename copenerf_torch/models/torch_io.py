"""Ingest PyTorch checkpoints of the reference implementation (port of
``copenerf_tpu/models/torch_io.py``).

Supports:
  * the pretrained SDF warm start (``pretrained_sdf/model.pt``, which the
    reference loads at ``train.py:41-43``): an IDR-style state dict of
    weight-normed layers ``lin{l}.weight_v`` (out, in), ``lin{l}.weight_g``
    (out, 1) and ``lin{l}.bias``;
  * full reference renderer checkpoints saved by the reference's
    ``model/checkpoints.py:29-46`` (keys ``model.module.<net>.<layer>.*``),
    so trained reference models migrate into the port.

The port's layers keep the same (out, in) layout, so the tensors copy
straight into the ``nn.Module``s; the JAX package transposes them into its
(in, out) tree instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


def _copy_(param: torch.Tensor, value: torch.Tensor) -> None:
    value = value.detach().to(torch.float32).reshape(param.shape)
    with torch.no_grad():
        param.copy_(value.to(param.device))


def _load_linear_(layer: nn.Module, sd: dict, prefix: str) -> None:
    if f"{prefix}.weight_v" in sd:
        _copy_(layer.v, sd[f"{prefix}.weight_v"])
        _copy_(layer.g, sd[f"{prefix}.weight_g"])
    else:
        _copy_(layer.w, sd[f"{prefix}.weight"])
    _copy_(layer.b, sd[f"{prefix}.bias"])


def idr_mlp_from_torch_(net: nn.Module, sd: dict) -> nn.Module:
    """Copy an IDR-style MLP state dict (``lin0`` .. ``lin{n-1}``) into
    ``net``'s layers of the same names, in place."""
    expected = {f"lin{l}" for l in range(len(net.layers))}
    if set(net.layers.keys()) != expected:
        raise ValueError(f"layers {sorted(net.layers.keys())} are not "
                         f"lin0..lin{len(net.layers) - 1}")
    for name, layer in net.layers.items():
        _load_linear_(layer, sd, name)
    return net


def load_pretrained_sdf(net: nn.Module, path: str) -> nn.Module:
    """Load the reference's pretrained SDF warm-start checkpoint into the
    port's ``SDFNetwork`` ``net`` (in place)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return idr_mlp_from_torch_(net, sd)


def nerf_from_torch_(net: nn.Module, sd: dict) -> nn.Module:
    """Copy a nerf-pytorch state dict (``pts_linears.{i}``,
    ``views_linears.0``, ``feature_linear``, ``alpha_linear``,
    ``rgb_linear``) into the port's ``NeRF`` ``net``, in place."""
    names = {f"pts{i}": f"pts_linears.{i}" for i in range(net.cfg.D)}
    names.update(views0="views_linears.0", feature="feature_linear",
                 alpha="alpha_linear", rgb="rgb_linear")
    for name, layer in net.layers.items():
        _load_linear_(layer, sd, names[name])
    return net


def variance_from_torch_(net: nn.Module, sd: dict) -> nn.Module:
    """Copy the reference's ``variance`` into a ``VarianceNetwork``."""
    _copy_(net.variance, sd["variance"])
    return net


def _strip_prefix(sd: dict, prefix: str) -> dict:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no keys with prefix {prefix!r}")
    return out


# The reference renderer's submodule of each of the port's networks, and
# the loader that copies it.
_REFERENCE_NETS = {
    "sdf": ("sdf_network.", idr_mlp_from_torch_),
    "color": ("color_network.", idr_mlp_from_torch_),
    "motion": ("motion_network.", idr_mlp_from_torch_),
    "variance": ("deviation_network.", variance_from_torch_),
    "nerf": ("nerf.", nerf_from_torch_),
}


def load_reference_renderer_checkpoint(path: str, configs: dict,
                                       device="cuda") -> dict:
    """Load a full reference training checkpoint into the port's networks.

    The reference saves ``{"model": DataParallel(NeuSRenderer).state_dict(),
    ...scalars}``; renderer submodules are ``module.sdf_network`` /
    ``deviation_network`` / ``color_network`` / ``motion_network`` / ``nerf``.
    ``configs`` (``fields.configs_from_cfg``) gives the networks' shapes.
    Returns ``{"fields": nn.ModuleDict (as init_all_fields), "scalars":
    {epoch_it, it, ...}}``. The file is read with ``weights_only=True``:
    tensors, containers and Python scalars, no arbitrary objects."""
    from .fields import init_all_fields

    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob["model"] if "model" in blob else blob
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v
          for k, v in sd.items()}
    # Every parameter is overwritten below; the generator keeps the init
    # off the global RNG.
    fields = init_all_fields(configs, torch.Generator().manual_seed(0),
                             device=device)
    for name, (prefix, load_) in _REFERENCE_NETS.items():
        load_(fields[name], _strip_prefix(sd, prefix))
    scalars = {k: v for k, v in blob.items()
               if not hasattr(v, "keys") and np.isscalar(v)}
    return {"fields": fields, "scalars": scalars}
