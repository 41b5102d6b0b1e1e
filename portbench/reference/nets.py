"""The field networks in plain PyTorch, on weights given as tensors.

Written from the published description of CoPE-NeRF's networks (NeuS's
SDF and IDR color MLPs, the continuous motion MLP), independent of the
program: a weight-normalized layer is ``W = g v / ||v||`` over the input
axis; the SDF's hidden activation is Softplus(beta=100); a skip layer
concatenates the encoded input and scales by 1/sqrt(2); the color MLP is
ReLU with a sigmoid head; the motion MLP is LeakyReLU(0.2).

``weights[net]`` is a list of ``(v (out, in), g (out,), b (out,))`` per
layer. ``precision="tf32"`` rounds both operands of every product to TF32
(10 mantissa bits) on the way in, with the gradient passed straight
through: the control of the comparison that decides ``correct``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INV_SQRT2 = 1.0 / math.sqrt(2.0)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return x + (round_tf32(x.detach()) - x).detach()


def linear(x, v, g, b, precision: str = "f32"):
    w = v * (g[:, None] / torch.linalg.norm(v, dim=1, keepdim=True))
    if precision == "tf32":
        x, w = _tf32(x), _tf32(w)
    return F.linear(x, w, b)


def encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^k x), cos(2^k x) for k < multires]."""
    parts = [x]
    for k in range(multires):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1) if multires > 0 else x


def sdf_forward(layers, cfg: dict, x, precision="f32"):
    """(..., 4) -> (..., d_out): the value (first column) and the feature."""
    scale = cfg["scale"]
    inputs = encode(x * scale, cfg["multires"])
    h = inputs
    last = len(layers) - 1
    for l, (v, g, b) in enumerate(layers):
        if l in cfg["skip_in"]:
            h = torch.cat([h, inputs], dim=-1) * INV_SQRT2
        h = linear(h, v, g, b, precision)
        if l < last:
            h = F.softplus(h, beta=100.0, threshold=20.0)
    return torch.cat([h[..., :1] / scale, h[..., 1:]], dim=-1)


def sdf_value_and_grad(layers, cfg, x, precision="f32"):
    """(out, d value / d x): ``out`` keeps its dependence on ``x``; the
    gradient is taken at ``x`` detached, with its graph to the weights kept
    where grad mode is on (the second-order terms of the losses)."""
    out = sdf_forward(layers, cfg, x, precision)
    build = torch.is_grad_enabled()
    with torch.enable_grad():
        xd = x.detach().requires_grad_(True)
        val = sdf_forward(layers, cfg, xd, precision)[..., 0]
        grad, = torch.autograd.grad(val.sum(), xd, create_graph=build)
    if not build:
        out, grad = out.detach(), grad.detach()
    return out, grad


def color_forward(layers, cfg: dict, pts, normals, dirs, feature,
                  precision="f32"):
    """IDR color: [points, encoded view dirs, normals, feature] -> rgb."""
    view = encode(dirs, cfg["multires_view"])
    h = torch.cat([pts, view, normals, feature], dim=-1)
    last = len(layers) - 1
    for l, (v, g, b) in enumerate(layers):
        h = linear(h, v, g, b, precision)
        if l < last:
            h = F.relu(h)
    return torch.sigmoid(h)


def motion_forward(layers, cfg: dict, t, precision="f32"):
    """(..., 1) time -> (angular velocity (..., 3), velocity (..., 3))."""
    inputs = encode(t, cfg["multires"])
    h = inputs
    last = len(layers) - 1
    for l, (v, g, b) in enumerate(layers):
        if l in cfg["skip_in"]:
            h = torch.cat([h, inputs], dim=-1) * INV_SQRT2
        h = linear(h, v, g, b, precision)
        if l < last:
            h = F.leaky_relu(h, negative_slope=0.2)
    h = h * cfg["scale"]
    return h[..., :3], h[..., 3:]
