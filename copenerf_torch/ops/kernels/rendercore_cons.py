"""K6 — the render-core field query with the sdf-consistency re-query folded
into the same launches: K6-fwd (``csrc/rendercore_fwd.cu``, ``kCons``) and
its backward K6-bwd (``csrc/rendercore_bwd.cu``, ``kCons``).

Replaces ``copenerf_tpu/ops/pallas/rendercore_kernels.py`` ``fwd_kernel``
and ``bwd_kernel`` with ``with_cons=True`` (``get_fused_rendercore_cons``,
the JAX package's ``COPENERF_FOLD_CONS=1``): K1 on (x, dirs) and, in the
same launch, K3 (the differentiable SDF value) on y, the world-transformed
samples; the backward sums both row sets' weight gradients in one reduction.
``rendercore_cons`` routes on the tensor's device: a CUDA tensor goes
through ``RenderCoreCons`` (an ``autograd.Function`` whose forward launches
K6-fwd and whose backward launches K6-bwd, or raises), a CPU tensor takes
``rendercore_cons_plain``. The Function's inputs are x, dirs, y and both
nets' effective weights and biases, so autograd carries the kernel's W-bars
through weight norm. The pack and the gradient layout are K1's
(``pack_rendercore_layers``, ``rendercore_grad_layout``): K6's y query
reads the SDF weights K1 packs, and its W/b bars go to the same slots.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build
from .pack import (effective_layers, pack_rendercore_layers,
                   rendercore_grad_layout, unpack_rendercore_grads)
from .rendercore import _check_rows, _geometry, rendercore_fwd_plain
from .sdf_value_diff import sdf_value_diff_plain

FWD_COUNTER = build.KernelCounter("rendercore_cons_fwd")
BWD_COUNTER = build.KernelCounter("rendercore_cons_bwd")


def rendercore_cons_plain(sdf_net, color_net, x: torch.Tensor,
                          dirs: torch.Tensor, y: torch.Tensor):
    """K1's plain version on (x, dirs) and K3's on y, on every device:
    (sdf (...,1), grad (...,4), color (...,3), sdf_w (...,))."""
    sdf, grad, color = rendercore_fwd_plain(sdf_net, color_net, x, dirs)
    return sdf, grad, color, sdf_value_diff_plain(sdf_net, y)


def _check_cons(scfg, ccfg, x, dirs, y) -> None:
    _check_rows(scfg, ccfg, x, dirs)
    build.check_input(y, "y", 4)
    if y.shape[0] != x.shape[0] or y.device != x.device:
        raise ValueError("x and y must have the same rows and device")


def launch_cons_fwd(scfg, ccfg, packed, x, dirs, y):
    """K6-fwd on (n, 4) points, (n, 3) dirs and (n, 4) world-transformed
    points, contiguous f32 CUDA, with a render-core pack -> (sdf (n, 1),
    grad (n, 4), color (n, 3), sdf_w (n,))."""
    _check_cons(scfg, ccfg, x, dirs, y)
    params, offs = packed
    if params.device != x.device:
        raise ValueError(f"weights on {params.device}, x on {x.device}")
    n, dev = x.shape[0], x.device
    f32 = dict(dtype=torch.float32, device=dev)
    sdf = torch.empty((n, 1), **f32)
    grad = torch.empty((n, 4), **f32)
    color = torch.empty((n, 3), **f32)
    sdf_w = torch.empty((n,), **f32)
    blocks = build.n_blocks(dev)
    sgeom, cgeom = _geometry(scfg, ccfg)
    scratch = torch.empty(blocks * (sgeom[0] - 1) * 64 * 256, **f32)
    O = build.offsets
    code = build.load_library().copenerf_rendercore_cons_fwd(
        x.data_ptr(), dirs.data_ptr(), y.data_ptr(), sdf.data_ptr(),
        grad.data_ptr(), color.data_ptr(), sdf_w.data_ptr(), params.data_ptr(),
        O(offs["w"]), O(offs["b"]), O(offs["wt"]), offs["w_last0"],
        offs["b_last0"], offs["w_feat"], offs["b_feat"], O(offs["wc"]),
        O(offs["bc"]), scratch.data_ptr(), n, *sgeom, float(scfg.scale),
        *cgeom, int(ccfg.squeeze_out), blocks, build.stream(x))
    build.check(code, "rendercore_cons_fwd")
    FWD_COUNTER.launches += 1
    return sdf, grad, color, sdf_w


def rendercore_cons_bwd_cuda(scfg, ccfg, packed, x, dirs, y, sbar, gbar, cbar,
                             swbar):
    """K6-bwd for the cotangents sbar (n, 1), gbar (n, 4), cbar (n, 3) and
    swbar (n,) -> (x_bar (n, 4), dirs_bar (n, 3), y_bar (n, 4),
    [(W_bar, b_bar)] per SDF layer, [(W_bar, b_bar)] per color layer),
    W_bar (out, in)."""
    _check_cons(scfg, ccfg, x, dirs, y)
    for t, name, w in ((sbar, "sbar", 1), (gbar, "gbar", 4), (cbar, "cbar", 3),
                       (swbar.reshape(-1, 1), "swbar", 1)):
        build.check_input(t, name, w)
        if t.shape[0] != x.shape[0]:
            raise ValueError(f"{name}: {t.shape[0]} rows, x has {x.shape[0]}")
    params, offs = packed
    goffs, gsize = rendercore_grad_layout(scfg, ccfg)
    n, dev = x.shape[0], x.device
    blocks = build.n_blocks(dev)
    sgeom, cgeom = _geometry(scfg, ccfg)
    lib = build.load_library()
    n_stage, n_part, n_scratch = build.workspace(
        lib.copenerf_rendercore_cons_bwd_workspace, n, *sgeom, *cgeom, blocks)
    f32 = dict(dtype=torch.float32, device=dev)
    stage = torch.empty(n_stage, **f32)
    partial = torch.empty(n_part, **f32)
    scratch = torch.empty(n_scratch, **f32)
    grads = torch.zeros(gsize, **f32)
    x_bar = torch.empty((n, 4), **f32)
    d_bar = torch.empty((n, 3), **f32)
    y_bar = torch.empty((n, 4), **f32)
    O = build.offsets
    code = lib.copenerf_rendercore_cons_bwd(
        x.data_ptr(), dirs.data_ptr(), y.data_ptr(), sbar.data_ptr(),
        gbar.data_ptr(), cbar.data_ptr(), swbar.data_ptr(), x_bar.data_ptr(),
        d_bar.data_ptr(), y_bar.data_ptr(), params.data_ptr(), O(offs["w"]),
        O(offs["b"]), O(offs["wt"]), offs["w_last0"], offs["b_last0"],
        offs["w_feat"], offs["b_feat"], offs["w_feat_t"], O(offs["wc"]),
        O(offs["bc"]), O(offs["wct"]), grads.data_ptr(), O(goffs["gw"]),
        O(goffs["gb"]), goffs["gw_last0"], O(goffs["gwc"]), O(goffs["gbc"]),
        stage.data_ptr(), partial.data_ptr(), scratch.data_ptr(), n, *sgeom,
        float(scfg.scale), *cgeom, int(ccfg.squeeze_out), blocks,
        build.stream(x))
    build.check(code, "rendercore_cons_bwd")
    BWD_COUNTER.launches += 1
    sdf_bars, color_bars = unpack_rendercore_grads(grads, goffs, scfg, ccfg)
    return x_bar, d_bar, y_bar, sdf_bars, color_bars


class RenderCoreCons(torch.autograd.Function):
    """(sdf (n, 1), grad (n, 4), color (n, 3), sdf_w (n,)) of x (n, 4),
    dirs (n, 3), y (n, 4); inputs after y: the effective W (out, in) of
    every SDF layer, every SDF b, every color W, every color b. Cotangents
    that arrive as None count as zeros."""

    @staticmethod
    def forward(ctx, scfg, ccfg, x, dirs, y, *wb):
        ns, nc = len(scfg.dims) - 1, len(ccfg.dims) - 1
        sdf_layers = list(zip(wb[:ns], wb[ns:2 * ns]))
        color_layers = list(zip(wb[2 * ns:2 * ns + nc], wb[2 * ns + nc:]))
        packed = pack_rendercore_layers(sdf_layers, color_layers, ccfg)
        ctx.cfgs, ctx.packed = (scfg, ccfg), packed
        ctx.save_for_backward(x, dirs, y)
        return launch_cons_fwd(scfg, ccfg, packed, x, dirs, y)

    @staticmethod
    @once_differentiable
    def backward(ctx, sbar, gbar, cbar, swbar):
        x, dirs, y = ctx.saved_tensors
        n = x.shape[0]
        cots = [torch.zeros(shape, dtype=x.dtype, device=x.device)
                if c is None else c.contiguous()
                for c, shape in ((sbar, (n, 1)), (gbar, (n, 4)), (cbar, (n, 3)),
                                 (swbar, (n,)))]
        x_bar, d_bar, y_bar, sdf_bars, color_bars = rendercore_cons_bwd_cuda(
            *ctx.cfgs, ctx.packed, x, dirs, y, *cots)
        return (None, None, x_bar, d_bar, y_bar,
                *[w for w, _ in sdf_bars], *[b for _, b in sdf_bars],
                *[w for w, _ in color_bars], *[b for _, b in color_bars])


def rendercore_cons(sdf_net, color_net, x: torch.Tensor, dirs: torch.Tensor,
                    y: torch.Tensor):
    """(sdf (...,1), grad (...,4), color (...,3), sdf_w (...,)) of (..., 4)
    points, (..., 3) view dirs and (..., 4) world-transformed points,
    differentiable wherever grad mode asks for it."""
    if x.device.type == "cpu":
        return rendercore_cons_plain(sdf_net, color_net, x, dirs, y)
    lead = x.shape[:-1]
    ws_s, bs_s = zip(*effective_layers(sdf_net))
    ws_c, bs_c = zip(*effective_layers(color_net))
    sdf, grad, color, sdf_w = RenderCoreCons.apply(
        sdf_net.cfg, color_net.cfg, x.reshape(-1, 4).contiguous(),
        dirs.reshape(-1, 3).contiguous(), y.reshape(-1, 4).contiguous(),
        *ws_s, *bs_s, *ws_c, *bs_c)
    return (sdf.reshape(lead + (1,)), grad.reshape(lead + (4,)),
            color.reshape(lead + (3,)), sdf_w.reshape(lead))
