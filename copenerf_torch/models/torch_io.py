"""Ingest PyTorch checkpoints of the reference implementation (port of
``copenerf_tpu/models/torch_io.py``).

The pretrained SDF warm start (``pretrained_sdf/model.pt``, which the
reference loads at ``train.py:41-43``) is an IDR-style state dict of
weight-normed layers ``lin{l}.weight_v`` (out, in), ``lin{l}.weight_g``
(out, 1) and ``lin{l}.bias``. The port's layers keep the same (out, in)
layout, so the tensors copy straight into the ``nn.Module``s; the JAX
package transposes them into its (in, out) tree instead. Full reference
renderer checkpoints (``load_reference_renderer_checkpoint``) are not
ported yet.
"""

from __future__ import annotations

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
