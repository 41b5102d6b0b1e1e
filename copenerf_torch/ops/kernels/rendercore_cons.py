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
through weight norm. The pack and the gradient layout are K1's (the cached
``pack_rendercore``, ``rendercore_grad_layout``): K6's y query reads the
SDF weights K1 packs, and its W/b bars go to the same slots.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build
from .pack import (apply_with_cached_pack, pack_rendercore, rendercore_grad_layout,
                   unpack_rendercore_grads)
from .rendercore import (BWD_OFFSETS, FWD_OFFSETS, GRAD_OFFSETS, _check_rows,
                         _geometry, rendercore_fwd_plain)
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
    build.check_pack(params, x)
    n, (sgeom, cgeom) = x.shape[0], _geometry(scfg, ccfg)
    with FWD_COUNTER.launch():
        sdf, grad, color, sdf_w = build.outputs(x, 1, 4, 3, None)
        blocks = build.n_blocks(x.device)
        # per block: each hidden layer's sigmoids and the feature, 64 x 256 each
        scratch = torch.empty(blocks * sgeom[0] * 64 * 256, dtype=torch.float32,
                              device=x.device)
        build.call("rendercore_cons_fwd", x.data_ptr(), dirs.data_ptr(), y.data_ptr(),
                   sdf.data_ptr(), grad.data_ptr(), color.data_ptr(), sdf_w.data_ptr(),
                   params.data_ptr(), *offs.c(*FWD_OFFSETS), scratch.data_ptr(), n,
                   *sgeom, float(scfg.scale), *cgeom, int(ccfg.squeeze_out), blocks,
                   build.stream(x))
    return sdf, grad, color, sdf_w


def rendercore_cons_bwd_cuda(scfg, ccfg, packed, x, dirs, y, sbar, gbar, cbar,
                             swbar):
    """K6-bwd for the cotangents sbar (n, 1), gbar (n, 4), cbar (n, 3) and
    swbar (n,) -> (x_bar (n, 4), dirs_bar (n, 3), y_bar (n, 4),
    [(W_bar, b_bar)] per SDF layer, [(W_bar, b_bar)] per color layer),
    W_bar (out, in)."""
    _check_cons(scfg, ccfg, x, dirs, y)
    build.check_rows(x, (sbar, "sbar", 1), (gbar, "gbar", 4), (cbar, "cbar", 3),
                     (swbar.reshape(-1, 1), "swbar", 1))
    params, offs = packed
    goffs, gsize = rendercore_grad_layout(scfg, ccfg)
    n, (sgeom, cgeom) = x.shape[0], _geometry(scfg, ccfg)
    blocks = build.n_blocks(x.device)
    with BWD_COUNTER.launch():
        stage, partial, scratch, grads = build.bwd_buffers(
            "rendercore_cons_bwd", (n, *sgeom, *cgeom, blocks), gsize, x.device)
        x_bar, d_bar, y_bar = build.outputs(x, 4, 3, 4)
        build.call("rendercore_cons_bwd", x.data_ptr(), dirs.data_ptr(), y.data_ptr(),
                   sbar.data_ptr(), gbar.data_ptr(), cbar.data_ptr(), swbar.data_ptr(),
                   x_bar.data_ptr(), d_bar.data_ptr(), y_bar.data_ptr(),
                   params.data_ptr(), *offs.c(*BWD_OFFSETS), grads.data_ptr(),
                   *goffs.c(*GRAD_OFFSETS), stage.data_ptr(), partial.data_ptr(),
                   scratch.data_ptr(), n, *sgeom, float(scfg.scale), *cgeom,
                   int(ccfg.squeeze_out), blocks, build.stream(x))
        sdf_bars, color_bars = unpack_rendercore_grads(grads, goffs, scfg, ccfg)
    return x_bar, d_bar, y_bar, sdf_bars, color_bars


class RenderCoreCons(torch.autograd.Function):
    """(sdf (n, 1), grad (n, 4), color (n, 3), sdf_w (n,)) of x (n, 4),
    dirs (n, 3), y (n, 4); ``packed`` is the render-core pack
    (``pack.pack_rendercore``) of the inputs after y: the effective W
    (out, in) of every SDF layer, every SDF b, every color W, every color
    b, which carry the gradients. Cotangents that arrive as None count as
    zeros."""

    @staticmethod
    def forward(ctx, scfg, ccfg, packed, x, dirs, y, *wb):
        ctx.cfgs, ctx.packed = (scfg, ccfg), packed
        ctx.save_for_backward(x, dirs, y)
        return launch_cons_fwd(scfg, ccfg, packed, x, dirs, y)

    @staticmethod
    @once_differentiable
    def backward(ctx, sbar, gbar, cbar, swbar):
        x, dirs, y = ctx.saved_tensors
        cots = build.cotangents(x, (sbar, gbar, cbar, swbar), (1, 4, 3, None))
        x_bar, d_bar, y_bar, sdf_bars, color_bars = rendercore_cons_bwd_cuda(
            *ctx.cfgs, ctx.packed, x, dirs, y, *cots)
        return (None, None, None, x_bar, d_bar, y_bar,
                *build.weight_args(sdf_bars, color_bars))


def rendercore_cons(sdf_net, color_net, x: torch.Tensor, dirs: torch.Tensor,
                    y: torch.Tensor):
    """(sdf (...,1), grad (...,4), color (...,3), sdf_w (...,)) of (..., 4)
    points, (..., 3) view dirs and (..., 4) world-transformed points,
    differentiable wherever grad mode asks for it."""
    if x.device.type == "cpu":
        return rendercore_cons_plain(sdf_net, color_net, x, dirs, y)
    lead = x.shape[:-1]
    out = apply_with_cached_pack(
        RenderCoreCons, (sdf_net, color_net), pack_rendercore,
        x.reshape(-1, 4).contiguous(), dirs.reshape(-1, 3).contiguous(),
        y.reshape(-1, 4).contiguous())
    return tuple(t.reshape(lead + t.shape[1:]) for t in out)
