"""Weight-normalized linear layers (port of ``copenerf_tpu/models/mlp.py``).

``WeightNormLinear`` keeps PyTorch's (out, in) layout: ``v`` (out, in),
``g`` (out,), ``b`` (out,), with the effective weight ``W = g * v / ||v||``
and the norm taken over the INPUT axis (dim 1 here; axis 0 of the JAX
package's (in, out) ``v``). ``models/exchange.py`` converts between the two
layouts.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _init_weight(d_in: int, d_out: int, init: str, generator, *,
                 mean: float = 0.0, std: float | None = None,
                 bias_const: float | None = None, zero_in_cols=None):
    """(weight (out, in), bias (out,)) drawn as ``mlp.make_linear`` does."""
    if init == "torch_default":
        bound = 1.0 / math.sqrt(d_in)
        w = (torch.rand((d_out, d_in), generator=generator) * 2 - 1) * bound
        b = (torch.rand((d_out,), generator=generator) * 2 - 1) * bound
    elif init == "normal":
        w = mean + std * torch.randn((d_out, d_in), generator=generator)
        b = torch.full((d_out,), 0.0 if bias_const is None else bias_const)
        if zero_in_cols is not None:
            w[:, zero_in_cols] = 0.0
    else:
        raise ValueError(init)
    return w.float(), b.float()


class WeightNormLinear(nn.Module):
    """``y = x @ W^T + b`` with ``W = g * v / ||v||_row``."""

    def __init__(self, d_in: int, d_out: int, init: str = "torch_default",
                 generator=None, **init_kw):
        super().__init__()
        w, b = _init_weight(d_in, d_out, init, generator, **init_kw)
        self.v = nn.Parameter(w)
        self.g = nn.Parameter(torch.linalg.norm(w, dim=1))
        self.b = nn.Parameter(b)

    def effective_weight(self) -> torch.Tensor:
        """The (out, in) effective weight."""
        norm = torch.linalg.norm(self.v, dim=1, keepdim=True)
        return self.v * (self.g[:, None] / norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.b)


class Linear(nn.Module):
    """Plain linear layer with the same ``effective_weight`` interface."""

    def __init__(self, d_in: int, d_out: int, init: str = "torch_default",
                 generator=None, **init_kw):
        super().__init__()
        w, b = _init_weight(d_in, d_out, init, generator, **init_kw)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def effective_weight(self) -> torch.Tensor:
        return self.w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w, self.b)


def make_linear(d_in: int, d_out: int, weight_norm: bool = True,
                init: str = "torch_default", generator=None, **init_kw):
    cls = WeightNormLinear if weight_norm else Linear
    return cls(d_in, d_out, init, generator, **init_kw)


@torch.no_grad()
def perturb_(module: nn.Module, generator) -> nn.Module:
    """Add seeded N(0, 0.1 / sqrt(fan_in)) noise to the weight (``v`` or
    ``w``) and the bias of every linear layer in ``module``, in place.

    The geometric init zeroes the SDF's PE input columns and draws its head's
    columns almost equal, so a check on those weights cannot see the PE or
    the column order; kernel checks run on perturbed weights instead."""
    for layer in module.modules():
        if isinstance(layer, (WeightNormLinear, Linear)):
            w = layer.v if isinstance(layer, WeightNormLinear) else layer.w
            std = 0.1 / math.sqrt(w.shape[1])
            for p in (w, layer.b):
                p += (std * torch.randn(p.shape, generator=generator)).to(p)
    return module


def softplus(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """torch ``nn.Softplus`` semantics: identity where beta * x > 20."""
    return F.softplus(x, beta=beta, threshold=20.0)
