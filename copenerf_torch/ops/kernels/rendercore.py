"""K1 — the render-core field query: K1-fwd (``csrc/rendercore_fwd.cu``) and
its second-order backward K1-bwd (``csrc/rendercore_bwd.cu``).

Replaces ``copenerf_tpu/ops/pallas/rendercore_kernels.py`` ``fwd_kernel`` and
``bwd_kernel`` (``get_fused_rendercore``): SDF value, its input gradient and
the IDR color in one launch, the 256-wide feature kept on chip; the backward
carries the eikonal / sdf-flow / color-through-normal double backprop.
``rendercore_fwd`` routes on the tensor's device: a CUDA tensor launches the
forward kernel alone when nothing needs a gradient, and otherwise goes
through ``RenderCore`` (an ``autograd.Function`` whose forward launches
K1-fwd and whose backward launches K1-bwd, or its frozen-fields kernel
when no weight needs a gradient); a CPU tensor takes
``rendercore_fwd_plain``, under autograd when grad mode is on. The
Function's inputs are x, dirs and both nets' effective weights and biases,
so autograd carries the kernel's W-bars through weight norm, and their
render-core pack, the one cached on the SDF net that K1-fwd's no-grad
launches read.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...models.fields import (color_apply_plain,
                              sdf_output_and_gradient_plain)
from . import build
from .color import color_relu_margin as _color_margin
from .pack import (apply_with_cached_pack, check_color_geometry, check_sdf_geometry,
                   color_geometry, pack_rendercore, rendercore_grad_layout,
                   sdf_geometry, unpack_rendercore_grads)

COUNTER = build.KernelCounter("rendercore_fwd")
BWD_COUNTER = build.KernelCounter("rendercore_bwd")
FROZEN_BWD_COUNTER = build.KernelCounter("rendercore_bwd_frozen")


def rendercore_fwd_plain(sdf_net, color_net, x: torch.Tensor,
                         dirs: torch.Tensor):
    """The composed path in plain PyTorch on every device (the yardstick of
    K1 on the card too): SDF forward, ``autograd.grad`` with the input
    detached (``create_graph`` under grad mode, so the second-order terms
    reach the weights), color MLP. Returns (sdf (...,1), grad (...,4),
    color (...,3))."""
    out, grad = sdf_output_and_gradient_plain(sdf_net, x)
    color = color_apply_plain(color_net, x, grad, dirs, out[..., 1:])
    return out[..., :1], grad, color


def color_relu_margin(sdf_net, color_net, x: torch.Tensor,
                      dirs: torch.Tensor) -> torch.Tensor:
    """(n,) the smallest |pre-activation| of the color MLP's ReLUs in each
    row of the plain render-core query (``color.color_relu_margin``), for
    the checks of K1-bwd."""
    with torch.no_grad():
        out, grad = sdf_output_and_gradient_plain(sdf_net, x)
    return _color_margin(color_net, x, dirs, grad, out[..., 1:])


def _geometry(scfg, ccfg) -> tuple:
    """The C entry points' SDF and color geometry arguments."""
    return sdf_geometry(scfg), color_geometry(ccfg)


def _check_rows(scfg, ccfg, x, dirs) -> None:
    check_sdf_geometry(scfg)
    check_color_geometry(scfg, ccfg)
    build.check_input(x, "x", 4)
    build.check_input(dirs, "dirs", 3)
    if dirs.shape[0] != x.shape[0] or dirs.device != x.device:
        raise ValueError("x and dirs must have the same rows and device")


# The pack offsets of the forward entries (K1-fwd, K6-fwd): per SDF hidden
# layer b, W and W^T as wgmma B; the head's column 0, its bias, its feature
# columns as wgmma B and their bias; per hidden color layer W as wgmma B;
# every color b; the color head (hidden, 3).
FWD_OFFSETS = ("b", "wp", "wtp", "w_last0", "b_last0", "wfp", "b_feat", "wcp",
               "bc", "wc_last")
# The backward entries' (K1-bwd, K6-bwd): the forward's with the feature
# columns' transpose as wgmma B, each hidden color layer's W^T as wgmma B
# (layer 0's columns < 256, then the rest: 0 when k0 <= 256) and the color
# head (3, hidden).
BWD_OFFSETS = ("b", "wp", "wtp", "w_last0", "b_last0", "wfp", "wftp", "b_feat",
               "wcp", "wctp", "wct0tp", "bc", "wc_last", "wct_last")
GRAD_OFFSETS = ("gw", "gb", "gw_last0", "gwc", "gbc")


def launch_fwd(scfg, ccfg, packed, x: torch.Tensor, dirs: torch.Tensor):
    """K1-fwd on (n, 4) points and (n, 3) dirs, contiguous f32 CUDA, with a
    render-core pack -> (sdf (n, 1), grad (n, 4), color (n, 3))."""
    _check_rows(scfg, ccfg, x, dirs)
    params, offs = packed
    build.check_pack(params, x)
    n, (sgeom, cgeom) = x.shape[0], _geometry(scfg, ccfg)
    with COUNTER.launch():
        sdf, grad, color = build.outputs(x, 1, 4, 3)
        blocks = build.n_blocks(x.device)
        # per block: each hidden layer's sigmoids and the feature, 64 x 256 each
        scratch = torch.empty(blocks * sgeom[0] * 64 * 256, dtype=torch.float32,
                              device=x.device)
        build.call("rendercore_fwd", x.data_ptr(), dirs.data_ptr(), sdf.data_ptr(),
                   grad.data_ptr(), color.data_ptr(), params.data_ptr(),
                   *offs.c(*FWD_OFFSETS), scratch.data_ptr(), n, *sgeom,
                   float(scfg.scale), *cgeom, int(ccfg.squeeze_out), blocks,
                   build.stream(x))
    return sdf, grad, color


def rendercore_fwd_cuda(sdf_net, color_net, x: torch.Tensor,
                        dirs: torch.Tensor):
    """Launch K1-fwd alone (no autograd) on (n, 4) points and (n, 3) dirs,
    contiguous f32 CUDA -> (sdf (n, 1), grad (n, 4), color (n, 3))."""
    _check_rows(sdf_net.cfg, color_net.cfg, x, dirs)
    build.check_no_grad([x, dirs, *sdf_net.parameters(),
                         *color_net.parameters()], "rendercore_fwd")
    return launch_fwd(sdf_net.cfg, color_net.cfg,
                      pack_rendercore(sdf_net, color_net), x, dirs)


def rendercore_bwd_cuda(scfg, ccfg, packed, x, dirs, sbar, gbar, cbar):
    """K1-bwd for the cotangents sbar (n, 1), gbar (n, 4), cbar (n, 3) ->
    (x_bar (n, 4), dirs_bar (n, 3), [(W_bar, b_bar)] per SDF layer,
    [(W_bar, b_bar)] per color layer), W_bar (out, in)."""
    _check_rows(scfg, ccfg, x, dirs)
    build.check_rows(x, (sbar, "sbar", 1), (gbar, "gbar", 4), (cbar, "cbar", 3))
    params, offs = packed
    goffs, gsize = rendercore_grad_layout(scfg, ccfg)
    n, (sgeom, cgeom) = x.shape[0], _geometry(scfg, ccfg)
    blocks = build.n_blocks(x.device)
    with BWD_COUNTER.launch():
        stage, partial, scratch, grads = build.bwd_buffers(
            "rendercore_bwd", (n, *sgeom, *cgeom, blocks), gsize, x.device)
        x_bar, d_bar = build.outputs(x, 4, 3)
        build.call("rendercore_bwd", x.data_ptr(), dirs.data_ptr(), sbar.data_ptr(),
                   gbar.data_ptr(), cbar.data_ptr(), x_bar.data_ptr(), d_bar.data_ptr(),
                   params.data_ptr(), *offs.c(*BWD_OFFSETS), grads.data_ptr(),
                   *goffs.c(*GRAD_OFFSETS), stage.data_ptr(), partial.data_ptr(),
                   scratch.data_ptr(), n, *sgeom, float(scfg.scale), *cgeom,
                   int(ccfg.squeeze_out), blocks, build.stream(x))
        sdf_bars, color_bars = unpack_rendercore_grads(grads, goffs, scfg, ccfg)
    return x_bar, d_bar, sdf_bars, color_bars


def rendercore_bwd_frozen_cuda(scfg, ccfg, packed, x, dirs, sbar, cbar):
    """K1-bwd for frozen fields, the cotangents sbar (n, 1) and cbar (n, 3)
    -> (x_bar (n, 4), dirs_bar (n, 3)), bit for bit ``rendercore_bwd_cuda``'s
    (gbar's reaches neither): one row kernel, no weight gradient, no
    reduction."""
    _check_rows(scfg, ccfg, x, dirs)
    build.check_rows(x, (sbar, "sbar", 1), (cbar, "cbar", 3))
    params, offs = packed
    n, (sgeom, cgeom) = x.shape[0], _geometry(scfg, ccfg)
    blocks = build.n_blocks(x.device)
    with FROZEN_BWD_COUNTER.launch():
        scratch = build.bwd_buffers("rendercore_bwd_frozen", (sgeom[0], cgeom[1], blocks),
                                    None, x.device)
        x_bar, d_bar = build.outputs(x, 4, 3)
        build.call("rendercore_bwd_frozen", x.data_ptr(), dirs.data_ptr(),
                   sbar.data_ptr(), cbar.data_ptr(), x_bar.data_ptr(), d_bar.data_ptr(),
                   params.data_ptr(), *offs.c(*BWD_OFFSETS), scratch.data_ptr(), n,
                   *sgeom, float(scfg.scale), *cgeom, int(ccfg.squeeze_out), blocks,
                   build.stream(x))
    return x_bar, d_bar


class RenderCore(torch.autograd.Function):
    """(sdf (n, 1), grad (n, 4), color (n, 3)) of x (n, 4), dirs (n, 3);
    ``packed`` is the render-core pack (``pack.pack_rendercore``) of the
    inputs after dirs: the effective W (out, in) of every SDF layer, every
    SDF b, every color W, every color b, which carry the gradients.
    Cotangents that arrive as None count as zeros. When no weight or bias
    needs a gradient (frozen fields), the backward launches K1-bwd's
    frozen-fields kernel and returns None for each."""

    @staticmethod
    def forward(ctx, scfg, ccfg, packed, x, dirs, *wb):
        ctx.cfgs, ctx.packed = (scfg, ccfg), packed
        ctx.save_for_backward(x, dirs)
        return launch_fwd(scfg, ccfg, packed, x, dirs)

    @staticmethod
    @once_differentiable
    def backward(ctx, sbar, gbar, cbar):
        x, dirs = ctx.saved_tensors
        if not any(ctx.needs_input_grad[5:]):
            x_bar, d_bar = rendercore_bwd_frozen_cuda(
                *ctx.cfgs, ctx.packed, x, dirs, *build.cotangents(x, (sbar, cbar), (1, 3)))
            return (None, None, None, x_bar, d_bar,
                    *[None] * (len(ctx.needs_input_grad) - 5))
        x_bar, d_bar, sdf_bars, color_bars = rendercore_bwd_cuda(
            *ctx.cfgs, ctx.packed, x, dirs,
            *build.cotangents(x, (sbar, gbar, cbar), (1, 4, 3)))
        return (None, None, None, x_bar, d_bar, *build.weight_args(sdf_bars, color_bars))


def rendercore_fwd(sdf_net, color_net, x: torch.Tensor, dirs: torch.Tensor):
    """(sdf (...,1), grad (...,4), color (...,3)) of (..., 4) points and
    (..., 3) view dirs, differentiable wherever grad mode asks for it."""
    if x.device.type == "cpu":
        return rendercore_fwd_plain(sdf_net, color_net, x, dirs)
    lead = x.shape[:-1]
    rows = (x.reshape(-1, 4).contiguous(), dirs.reshape(-1, 3).contiguous())
    if build.needs_grad([*rows, *sdf_net.parameters(), *color_net.parameters()]):
        out = apply_with_cached_pack(RenderCore, (sdf_net, color_net), pack_rendercore,
                                     *rows)
    else:
        out = rendercore_fwd_cuda(sdf_net, color_net, *rows)
    return tuple(t.reshape(lead + t.shape[1:]) for t in out)
