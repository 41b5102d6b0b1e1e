"""Field networks as ``nn.Module``s (port of ``copenerf_tpu/models/fields.py``).

The five networks of the JAX package, with identical math:

  * ``SDFNetwork``       — time-conditioned SDF, IDR geometric init, weight
    norm, Softplus(beta=100), skip connection scaled by 1/sqrt(2).
  * ``ColorNetwork``     — IDR-style color head (modes idr / no_view_dir /
    no_normal).
  * ``VarianceNetwork``  — learnable inv_s = exp(10 v).
  * ``NeRF``             — nerf-pytorch background MLP.
  * ``MotionNetwork``    — t -> (angular velocity, linear velocity).

Each network keeps its frozen config in ``.cfg`` and its layers in a
``ModuleDict`` named exactly as the JAX parameter tree (``lin0``, ``pts3``,
...), so ``models/exchange.py`` maps the two one-to-one.

Routing: a CUDA tensor reaches the hand-written kernels
(``ops/kernels/``), a CPU tensor their plain versions; there is no mode
switch (the JAX package's ``set_fused_sdf`` has no counterpart).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .embedder import embed_dim, positional_encoding
from .mlp import make_linear, softplus

INV_SQRT2 = 1.0 / math.sqrt(2.0)


# ---------------------------------------------------------------------------
# Configs (copies of the JAX package's frozen dataclasses)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 4
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False

    @property
    def dims(self) -> Tuple[int, ...]:
        d0 = embed_dim(self.multires, self.d_in) if self.multires > 0 else self.d_in
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    d_in: int = 1
    d_out: int = 6
    d_hidden: int = 256
    n_layers: int = 4
    skip_in: Tuple[int, ...] = (2,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = False
    weight_norm: bool = True
    inside_outside: bool = False

    @property
    def dims(self) -> Tuple[int, ...]:
        d0 = embed_dim(self.multires, self.d_in) if self.multires > 0 else self.d_in
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


@dataclasses.dataclass(frozen=True)
class ColorConfig:
    d_feature: int = 256
    mode: str = "idr"
    d_in: int = 11
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True
    use_negative_ray_vector: bool = False

    @property
    def dims(self) -> Tuple[int, ...]:
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0:
            d0 += embed_dim(self.multires_view, 3) - 3
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


@dataclasses.dataclass(frozen=True)
class VarianceConfig:
    init_val: float = 0.3


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    output_ch: int = 4
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True

    @property
    def input_ch(self) -> int:
        return embed_dim(self.multires, self.d_in) if self.multires > 0 else 3

    @property
    def input_ch_view(self) -> int:
        return (embed_dim(self.multires_view, self.d_in_view)
                if self.multires_view > 0 else 3)


def idr_layer_dims(cfg, l: int) -> Tuple[int, int]:
    """(in, out) of layer ``l`` of an IDR MLP: the layer feeding a skip
    outputs ``dims[l+1] - dims[0]`` so the concat restores the width."""
    dims = cfg.dims
    out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
    return dims[l], out_dim


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------

class SDFNetwork(nn.Module):
    def __init__(self, cfg: SDFConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        layers = {}
        num_layers = len(cfg.dims)
        for l in range(num_layers - 1):
            d_in_l, d_out_l = idr_layer_dims(cfg, l)
            if not cfg.geometric_init:
                kw = dict(init="torch_default")
            elif l == num_layers - 2:
                sign = -1.0 if cfg.inside_outside else 1.0
                kw = dict(init="normal",
                          mean=sign * math.sqrt(math.pi) / math.sqrt(d_in_l),
                          std=1e-4, bias_const=-sign * cfg.bias)
            elif cfg.multires > 0 and l == 0:
                # Raw (x, y, z, t) channels get the kaiming draw; PE zero.
                kw = dict(init="normal", std=math.sqrt(2) / math.sqrt(d_out_l),
                          zero_in_cols=slice(cfg.d_in, None))
            elif cfg.multires > 0 and l in cfg.skip_in:
                n_zero = cfg.dims[0] - cfg.d_in
                kw = dict(init="normal", std=math.sqrt(2) / math.sqrt(d_out_l),
                          zero_in_cols=slice(d_in_l - n_zero, None))
            else:
                kw = dict(init="normal", std=math.sqrt(2) / math.sqrt(d_out_l))
            layers[f"lin{l}"] = make_linear(d_in_l, d_out_l, cfg.weight_norm,
                                            generator=generator, **kw)
        self.layers = nn.ModuleDict(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 4) -> (..., 257): sdf value (scale-corrected) + feature."""
        cfg = self.cfg
        inputs = x * cfg.scale
        if cfg.multires > 0:
            inputs = positional_encoding(inputs, cfg.multires)
        h = inputs
        num_layers = len(cfg.dims)
        for l in range(num_layers - 1):
            if l in cfg.skip_in:
                h = torch.cat([h, inputs], dim=-1) * INV_SQRT2
            h = self.layers[f"lin{l}"](h)
            if l < num_layers - 2:
                h = softplus(h, beta=100.0)
        return torch.cat([h[..., :1] / cfg.scale, h[..., 1:]], dim=-1)


def sdf_apply(net: SDFNetwork, x: torch.Tensor) -> torch.Tensor:
    return net(x)


def sdf_with_gradient(net: SDFNetwork, x: torch.Tensor,
                      create_graph: bool = False):
    """(sdf+feature, d(sdf)/dx) for (..., 4) inputs by one reverse pass."""
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
        out = net(xg)
        grad, = torch.autograd.grad(out[..., 0].sum(), xg,
                                    create_graph=create_graph)
    return out, grad


def sdf_output_and_gradient_plain(net: SDFNetwork, x: torch.Tensor):
    """(out, grad) with ``grad``'s x-dependence severed (the reference
    detaches pts before ``gradient()``); ``out`` stays differentiable. Plain
    PyTorch on every device."""
    if not torch.is_grad_enabled():
        out, grad = sdf_with_gradient(net, x.detach())
        return out.detach(), grad.detach()
    out = net(x)
    _, grad = sdf_with_gradient(net, x.detach(), create_graph=True)
    return out, grad


def sdf_output_and_gradient(net: SDFNetwork, x: torch.Tensor):
    """``sdf_output_and_gradient_plain`` for (..., 4) points; CUDA tensors
    run K4 (the outgrad kernel forward, its second-order backward kernel)."""
    from ..ops.kernels.outgrad import sdf_outgrad
    return sdf_outgrad(net, x)


def sdf_value_nograd(net: SDFNetwork, x: torch.Tensor) -> torch.Tensor:
    """SDF value only, for stop-gradient regions (importance sweeps).
    (..., 4) -> (...,). CUDA tensors run the value-sweep kernel."""
    from ..ops.kernels.sdf_value import sdf_value as _value
    return _value(net, x)


def sdf_scalar(net: SDFNetwork, x: torch.Tensor) -> torch.Tensor:
    """Differentiable SDF value only: (..., 4) -> (...,), for losses that
    never touch the feature head (sdf-consistency). CUDA tensors run K3
    (the value kernel forward, its first-order backward kernel)."""
    from ..ops.kernels.sdf_value_diff import sdf_value_diff
    return sdf_value_diff(net, x)


def sdf_grad_color(sdf_net: SDFNetwork, color_net: "ColorNetwork",
                   x: torch.Tensor, dirs: torch.Tensor):
    """The render-core field query: (sdf (...,1), grad (...,4), color (...,3)).

    With the reference's color config (idr, positive ray vector) this is the
    render-core op (for CUDA tensors K1-fwd, and K1-bwd when a gradient is
    asked for); otherwise it composes ``sdf_output_and_gradient`` +
    ``color_apply`` (for CUDA tensors K4, then K5 in the idr mode or the
    plain color MLP in the others, as in the JAX package)."""
    ccfg = color_net.cfg
    if ccfg.mode == "idr" and not ccfg.use_negative_ray_vector:
        from ..ops.kernels.rendercore import rendercore_fwd
        return rendercore_fwd(sdf_net, color_net, x, dirs)
    out, grad = sdf_output_and_gradient(sdf_net, x)
    color = color_apply(color_net, x, grad, dirs, out[..., 1:])
    return out[..., :1], grad, color


def sdf_grad_color_cons(sdf_net: SDFNetwork, color_net: "ColorNetwork",
                        x: torch.Tensor, dirs: torch.Tensor, y: torch.Tensor):
    """``sdf_grad_color`` plus the sdf-consistency re-query: the
    differentiable SDF value at the world-transformed batch ``y`` as a
    fourth output ``sdf_w (...,)``. Composed as ``sdf_grad_color`` and
    ``sdf_scalar`` (K1 or K4 + K5, then K3), the JAX package's default; its
    folded single-launch variant (``COPENERF_FOLD_CONS``) is not ported."""
    sdf, grad, color = sdf_grad_color(sdf_net, color_net, x, dirs)
    return sdf, grad, color, sdf_scalar(sdf_net, y)


# ---------------------------------------------------------------------------
# Motion network
# ---------------------------------------------------------------------------

class MotionNetwork(nn.Module):
    def __init__(self, cfg: MotionConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        layers = {}
        for l in range(len(cfg.dims) - 1):
            d_in_l, d_out_l = idr_layer_dims(cfg, l)
            layers[f"lin{l}"] = make_linear(d_in_l, d_out_l, cfg.weight_norm,
                                            "torch_default", generator)
        self.layers = nn.ModuleDict(layers)

    def forward(self, t: torch.Tensor):
        """(..., 1) time -> ((..., 3) angular velocity, (..., 3) velocity)."""
        cfg = self.cfg
        inputs = t
        if cfg.multires > 0:
            inputs = positional_encoding(inputs, cfg.multires)
        h = inputs
        num_layers = len(cfg.dims)
        for l in range(num_layers - 1):
            if l in cfg.skip_in:
                h = torch.cat([h, inputs], dim=-1) * INV_SQRT2
            h = self.layers[f"lin{l}"](h)
            if l < num_layers - 2:
                h = F.leaky_relu(h, negative_slope=0.2)
        h = h * cfg.scale
        return h[..., :3], h[..., 3:]


def motion_apply(net: MotionNetwork, t: torch.Tensor):
    return net(t)


# ---------------------------------------------------------------------------
# Rendering (color) network
# ---------------------------------------------------------------------------

class ColorNetwork(nn.Module):
    def __init__(self, cfg: ColorConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        dims = cfg.dims
        self.layers = nn.ModuleDict({
            f"lin{l}": make_linear(dims[l], dims[l + 1], cfg.weight_norm,
                                   "torch_default", generator)
            for l in range(len(dims) - 1)})

    def forward(self, points, normals, view_dirs, feature_vectors):
        """points (...,4) pts_time, normals (...,4) [n, sdf_flow],
        view_dirs (...,3), feature_vectors (..., d_feature)."""
        cfg = self.cfg
        if cfg.use_negative_ray_vector:
            view_dirs = -view_dirs
            normals = -normals
        if cfg.multires_view > 0:
            view_dirs = positional_encoding(view_dirs, cfg.multires_view)
        if cfg.mode == "idr":
            h = torch.cat([points, view_dirs, normals, feature_vectors], -1)
        elif cfg.mode == "no_view_dir":
            h = torch.cat([points, normals, feature_vectors], -1)
        elif cfg.mode == "no_normal":
            h = torch.cat([points, view_dirs, feature_vectors], -1)
        else:
            raise ValueError(cfg.mode)
        return self.mlp(h)

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The layers on the concatenated input: ReLU hidden layers, the
        sigmoid head when ``squeeze_out``."""
        num_layers = len(self.cfg.dims)
        for l in range(num_layers - 1):
            h = self.layers[f"lin{l}"](h)
            if l < num_layers - 2:
                h = F.relu(h)
        if self.cfg.squeeze_out:
            h = torch.sigmoid(h)
        return h


def color_apply_plain(net: ColorNetwork, points, normals, view_dirs,
                      feature_vectors) -> torch.Tensor:
    """The color net in plain PyTorch on every device."""
    return net(points, normals, view_dirs, feature_vectors)


def color_apply(net: ColorNetwork, points, normals, view_dirs,
                feature_vectors) -> torch.Tensor:
    """``color_apply_plain``; CUDA tensors in the idr mode run K5 (the color
    kernel forward, its backward kernel) on [points, dirs, normals,
    features], negated outside the kernel under ``use_negative_ray_vector``.
    The other modes stay plain on every device: the JAX package has no
    kernel for them."""
    if points.device.type == "cpu" or net.cfg.mode != "idr":
        return color_apply_plain(net, points, normals, view_dirs,
                                 feature_vectors)
    from ..ops.kernels.color import color_mlp
    if net.cfg.use_negative_ray_vector:
        view_dirs, normals = -view_dirs, -normals
    return color_mlp(net, points, view_dirs, normals, feature_vectors)


# ---------------------------------------------------------------------------
# Deviation (single-variance) network
# ---------------------------------------------------------------------------

class VarianceNetwork(nn.Module):
    def __init__(self, cfg: VarianceConfig):
        super().__init__()
        self.cfg = cfg
        self.variance = nn.Parameter(torch.tensor(cfg.init_val,
                                                  dtype=torch.float32))

    def forward(self) -> torch.Tensor:
        """inv_s = exp(10 v); callers clip to [1e-3, 1e3] at the use site."""
        return torch.exp(self.variance * 10.0)


def variance_inv_s(net: VarianceNetwork) -> torch.Tensor:
    return net()


# ---------------------------------------------------------------------------
# Background NeRF (nerf-pytorch MLP)
# ---------------------------------------------------------------------------

class NeRF(nn.Module):
    def __init__(self, cfg: NerfConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        layers = {}
        d_prev = cfg.input_ch
        for i in range(cfg.D):
            layers[f"pts{i}"] = make_linear(d_prev, cfg.W, False,
                                            "torch_default", generator)
            # nerf-pytorch concatenates [input_pts, h] AFTER layer i in skips.
            d_prev = cfg.W + cfg.input_ch if i in cfg.skips else cfg.W
        layers["views0"] = make_linear(cfg.input_ch_view + cfg.W, cfg.W // 2,
                                       False, "torch_default", generator)
        layers["feature"] = make_linear(cfg.W, cfg.W, False, "torch_default",
                                        generator)
        layers["alpha"] = make_linear(cfg.W, 1, False, "torch_default",
                                      generator)
        layers["rgb"] = make_linear(cfg.W // 2, 3, False, "torch_default",
                                    generator)
        self.layers = nn.ModuleDict(layers)

    def forward(self, input_pts, input_views):
        """(..., d_in) points, (..., 3) dirs -> (alpha (...,1), rgb (...,3))."""
        cfg = self.cfg
        if not cfg.use_viewdirs:
            raise NotImplementedError("reference asserts use_viewdirs")
        if cfg.multires > 0:
            input_pts = positional_encoding(input_pts, cfg.multires)
        if cfg.multires_view > 0:
            input_views = positional_encoding(input_views, cfg.multires_view)
        h = input_pts
        for i in range(cfg.D):
            h = F.relu(self.layers[f"pts{i}"](h))
            if i in cfg.skips:
                h = torch.cat([input_pts, h], dim=-1)
        alpha = self.layers["alpha"](h)
        feature = self.layers["feature"](h)
        h = torch.cat([feature, input_views], dim=-1)
        h = F.relu(self.layers["views0"](h))
        rgb = self.layers["rgb"](h)
        return alpha, rgb


def nerf_apply(net: NeRF, input_pts, input_views):
    return net(input_pts, input_views)


# ---------------------------------------------------------------------------
# Config constructors from the YAML dicts
# ---------------------------------------------------------------------------

def configs_from_cfg(cfg: dict) -> dict:
    """Build all field configs from a merged YAML config dict."""
    def _tup(x):
        return tuple(x) if isinstance(x, (list, tuple)) else (x,)

    sdf_c = cfg["neus_sdf_network"]
    mot_c = cfg["motion_network"]
    col_c = cfg["neus_rendering_network"]
    nerf_c = cfg["neus_nerf"]
    var_c = cfg["neus_variance_network"]
    return {
        "sdf": SDFConfig(
            d_in=sdf_c["d_in"], d_out=sdf_c["d_out"], d_hidden=sdf_c["d_hidden"],
            n_layers=sdf_c["n_layers"], skip_in=_tup(sdf_c["skip_in"]),
            multires=sdf_c["multires"], bias=sdf_c["bias"], scale=sdf_c["scale"],
            geometric_init=sdf_c["geometric_init"],
            weight_norm=sdf_c["weight_norm"]),
        "motion": MotionConfig(
            d_in=mot_c["d_in"], d_out=mot_c["d_out"], d_hidden=mot_c["d_hidden"],
            n_layers=mot_c["n_layers"], skip_in=_tup(mot_c["skip_in"]),
            multires=mot_c["multires"], bias=mot_c["bias"], scale=mot_c["scale"],
            geometric_init=mot_c["geometric_init"],
            weight_norm=mot_c["weight_norm"]),
        "color": ColorConfig(
            d_feature=col_c["d_feature"], mode=col_c["mode"], d_in=col_c["d_in"],
            d_out=col_c["d_out"], d_hidden=col_c["d_hidden"],
            n_layers=col_c["n_layers"], weight_norm=col_c["weight_norm"],
            multires_view=col_c["multires_view"],
            squeeze_out=col_c["squeeze_out"],
            use_negative_ray_vector=col_c["use_negative_ray_vector"]),
        "nerf": NerfConfig(
            D=nerf_c["D"], W=nerf_c["W"], d_in=nerf_c["d_in"],
            d_in_view=nerf_c["d_in_view"], multires=nerf_c["multires"],
            multires_view=nerf_c["multires_view"],
            output_ch=nerf_c["output_ch"], skips=_tup(nerf_c["skips"]),
            use_viewdirs=nerf_c["use_viewdirs"]),
        "variance": VarianceConfig(init_val=var_c["init_val"]),
    }


def init_all_fields(configs: dict, generator=None,
                    device="cuda") -> nn.ModuleDict:
    """All five networks in one ``ModuleDict`` (keys as the JAX params tree),
    initialized on the host from ``generator`` and moved to ``device``."""
    from ..device import resolve_device

    dev = resolve_device(device)
    return nn.ModuleDict({
        "sdf": SDFNetwork(configs["sdf"], generator),
        "motion": MotionNetwork(configs["motion"], generator),
        "color": ColorNetwork(configs["color"], generator),
        "nerf": NeRF(configs["nerf"], generator),
        "variance": VarianceNetwork(configs["variance"]),
    }).to(dev)
