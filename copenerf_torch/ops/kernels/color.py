"""K5 — the IDR color MLP: K5-fwd (``csrc/color_fwd.cu``) and its
first-order backward K5-bwd (``csrc/color_bwd.cu``).

Replaces ``copenerf_tpu/ops/pallas/color_kernels.py`` ``fwd_kernel`` and
``bwd_kernel`` (``get_fused_color``): the color MLP on [x, PE(dirs), grad,
feature], its four inputs concatenated on chip, with a backward to every
input and weight. The inputs are taken as they come: the negation of dirs
and grad under ``use_negative_ray_vector`` is the caller's
(``models.fields.color_apply``), as in the JAX package.

``color_mlp(net, x, dirs, grad, feat)`` routes on the tensor's device: a
CUDA tensor launches K5-fwd alone when nothing needs a gradient, and
otherwise goes through ``ColorMLP`` (an ``autograd.Function`` whose forward
launches K5-fwd and whose backward launches K5-bwd); a CPU tensor takes
``color_plain``. The feature may be a column slice of K4's 257-wide head:
the kernels read it at its row stride.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...models.embedder import positional_encoding
from . import build
from .pack import (apply_with_cached_pack, check_color_mlp_geometry, color_geometry,
                   color_grad_layout, pack_color, unpack_color_grads)

FWD_COUNTER = build.KernelCounter("color_fwd")
BWD_COUNTER = build.KernelCounter("color_bwd")


def color_plain(net, x, dirs, grad, feat) -> torch.Tensor:
    """(..., 3): the idr MLP of ``net`` on [x, PE(dirs), grad, feat], the
    inputs taken as they are (no negation)."""
    cfg = net.cfg
    if cfg.multires_view > 0:
        dirs = positional_encoding(dirs, cfg.multires_view)
    return net.mlp(torch.cat([x, dirs, grad, feat], -1))


def color_relu_margin(net, x, dirs, grad, feat) -> torch.Tensor:
    """(n,) the smallest |pre-activation| of the color MLP's ReLUs in each
    row, from the plain version. Where it lies within rounding of 0 the
    ReLU's derivative flips under any change of summation order, so the
    checks of the color backward kernels zero those rows' color cotangent."""
    pre = []
    hooks = [net.layers[f"lin{l}"].register_forward_hook(
        lambda m, i, o: pre.append(o.detach().abs().amin(-1)))
        for l in range(len(net.cfg.dims) - 2)]
    try:
        with torch.no_grad():
            color_plain(net, x, dirs, grad, feat)
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(pre).amin(0)


def _check_rows(ccfg, x, dirs, grad, feat) -> None:
    """x, dirs, grad contiguous; feat (n, d_feature) with unit column stride
    (its row stride may be wider: a slice of the SDF head)."""
    check_color_mlp_geometry(ccfg)
    for t, name, w in ((x, "x", 4), (dirs, "dirs", 3), (grad, "grad", 4)):
        build.check_input(t, name, w)
    if feat.device != x.device or feat.dtype != torch.float32:
        raise ValueError(f"feat: expected float32 on {x.device}, got "
                         f"{feat.dtype} on {feat.device}")
    if (feat.dim() != 2 or feat.shape[1] != ccfg.d_feature
            or feat.stride(1) != 1 or feat.stride(0) < ccfg.d_feature):
        raise ValueError(f"feat: expected (n, {ccfg.d_feature}) rows with unit "
                         f"column stride, got {tuple(feat.shape)} strides "
                         f"{feat.stride()}")
    for t, name in ((dirs, "dirs"), (grad, "grad"), (feat, "feat")):
        if t.shape[0] != x.shape[0]:
            raise ValueError(f"{name}: {t.shape[0]} rows, x has {x.shape[0]}")


def launch_color_fwd(ccfg, packed, x, dirs, grad, feat) -> torch.Tensor:
    """K5-fwd with a color pack -> color (n, 3)."""
    _check_rows(ccfg, x, dirs, grad, feat)
    params, offs = packed
    build.check_pack(params, x)
    with FWD_COUNTER.launch():
        color, = build.outputs(x, 3)
        build.call("color_fwd", x.data_ptr(), dirs.data_ptr(), grad.data_ptr(),
                   feat.data_ptr(), feat.stride(0), color.data_ptr(), params.data_ptr(),
                   *offs.c("wcp", "bc", "wc_last"), x.shape[0], *color_geometry(ccfg),
                   int(ccfg.squeeze_out), build.stream(x))
    return color


def color_fwd_cuda(net, x, dirs, grad, feat) -> torch.Tensor:
    """Launch K5-fwd alone (no autograd) -> color (n, 3)."""
    _check_rows(net.cfg, x, dirs, grad, feat)
    build.check_no_grad([x, dirs, grad, feat, *net.parameters()], "color_fwd")
    return launch_color_fwd(net.cfg, pack_color(net), x, dirs, grad, feat)


def color_bwd_cuda(ccfg, packed, x, dirs, grad, feat, cbar):
    """K5-bwd for the cotangent cbar (n, 3) -> (x_bar (n, 4), dirs_bar
    (n, 3), grad_bar (n, 4), feat_bar (n, d_feature), [(W_bar (out, in),
    b_bar)] per color layer)."""
    _check_rows(ccfg, x, dirs, grad, feat)
    build.check_rows(x, (cbar, "cbar", 3))
    params, offs = packed
    goffs, gsize = color_grad_layout(ccfg)
    n, geom = x.shape[0], color_geometry(ccfg)
    with BWD_COUNTER.launch():
        stage, partial, _, grads = build.bwd_buffers("color_bwd", (n, *geom), gsize,
                                                     x.device)
        x_bar, d_bar, g_bar, f_bar = build.outputs(x, 4, 3, 4, ccfg.d_feature)
        build.call("color_bwd", x.data_ptr(), dirs.data_ptr(), grad.data_ptr(),
                   feat.data_ptr(), feat.stride(0), cbar.data_ptr(), x_bar.data_ptr(),
                   d_bar.data_ptr(), g_bar.data_ptr(), f_bar.data_ptr(),
                   params.data_ptr(),
                   *offs.c("wcp", "wctp", "bc", "wct0tp", "wc_last", "wct_last"),
                   grads.data_ptr(), *goffs.c("gwc", "gbc"), stage.data_ptr(),
                   partial.data_ptr(), n, *geom, int(ccfg.squeeze_out), build.stream(x))
        bars = unpack_color_grads(grads, goffs, ccfg)
    return x_bar, d_bar, g_bar, f_bar, bars


class ColorMLP(torch.autograd.Function):
    """color (n, 3) of x (n, 4), dirs (n, 3), grad (n, 4), feat
    (n, d_feature); ``packed`` is the color pack (``pack.pack_color``) of
    the inputs after feat: the effective W (out, in) of every color layer,
    then every b, which carry the gradients."""

    @staticmethod
    def forward(ctx, ccfg, packed, x, dirs, grad, feat, *wb):
        ctx.ccfg, ctx.packed = ccfg, packed
        ctx.save_for_backward(x, dirs, grad, feat)
        return launch_color_fwd(ccfg, packed, x, dirs, grad, feat)

    @staticmethod
    @once_differentiable
    def backward(ctx, cbar):
        x = ctx.saved_tensors[0]
        cbar, = build.cotangents(x, (cbar,), (3,))
        x_bar, d_bar, g_bar, f_bar, bars = color_bwd_cuda(
            ctx.ccfg, ctx.packed, *ctx.saved_tensors, cbar)
        return (None, None, x_bar, d_bar, g_bar, f_bar, *build.weight_args(bars))


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) rows of t with unit column stride, a view where one does."""
    t = t.reshape(-1, width)
    return t if t.stride(1) == 1 and t.stride(0) >= width else t.contiguous()


def color_mlp(net, x, dirs, grad, feat) -> torch.Tensor:
    """(..., 3) color of (..., 4) points, (..., 3) dirs, (..., 4) SDF
    gradients and (..., d_feature) features, differentiable wherever grad
    mode asks for it."""
    if x.device.type == "cpu":
        return color_plain(net, x, dirs, grad, feat)
    ccfg = net.cfg
    lead = x.shape[:-1]
    rows = (x.reshape(-1, 4).contiguous(), dirs.reshape(-1, 3).contiguous(),
            grad.reshape(-1, 4).contiguous(), _rows(feat, ccfg.d_feature))
    if build.needs_grad([*rows, *net.parameters()]):
        color = apply_with_cached_pack(ColorMLP, (net,), pack_color, *rows)
    else:
        color = color_fwd_cuda(net, *rows)
    return color.reshape(lead + (3,))
