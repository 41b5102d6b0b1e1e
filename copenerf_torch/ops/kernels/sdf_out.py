"""K7 — the SDF output with a first-order backward: K7-fwd is the outgrad
kernel without its gradient sweep (``csrc/sdf_outgrad_fwd.cu``,
``kWithGrad = false``), K7-bwd the value backward over the whole head
(``csrc/sdf_value_bwd.cu`` ``sdf_out_bwd_kernel``, launched with
``kFullHead = true``), both on the wgmma 3xTF32 core with the outgrad pack's
weights.

Replaces ``copenerf_tpu/ops/pallas/sdf_kernels.py`` ``make_fwd_kernel`` /
``make_bwd_kernel`` with ``with_grad=False`` / ``second_order=False``
(``FusedOps.out``): out = [sdf, feature] (the 257-wide head) of each row,
differentiable to first order in x and the weights. ``sdf_out(net, x)``
routes on the tensor's device: a CUDA tensor goes through ``SdfOut`` (an
``autograd.Function`` whose forward launches K7-fwd and whose backward
launches K7-bwd, or raises), a CPU tensor takes ``sdf_out_plain``. The
Function's inputs are x and the SDF net's effective weights and biases, so
autograd carries the kernel's W-bars through weight norm, and their
outgrad pack, the one cached on the net.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build
from .pack import (apply_with_cached_pack, check_outgrad_geometry, pack_outgrad,
                   sdf_geometry, sdf_value_grad_layout, unpack_sdf_value_grads)

FWD_COUNTER = build.KernelCounter("sdf_out_fwd")
BWD_COUNTER = build.KernelCounter("sdf_out_bwd")


def sdf_out_plain(net, x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., d_out): ``sdf_apply`` under autograd."""
    return net(x)


def _check(cfg, packed, x):
    check_outgrad_geometry(cfg)
    build.check_input(x, "x", 4)
    build.check_pack(packed[0], x)


def launch_out_fwd(cfg, packed, x: torch.Tensor) -> torch.Tensor:
    """K7-fwd on (n, 4) contiguous f32 CUDA rows with an outgrad pack
    (``pack.pack_outgrad``) -> out (n, d_out)."""
    _check(cfg, packed, x)
    params, offs = packed
    with FWD_COUNTER.launch():
        out, = build.outputs(x, cfg.d_out)
        build.call("sdf_out_fwd", x.data_ptr(), out.data_ptr(), params.data_ptr(),
                   *offs.c("b", "wp", "w_last0", "b_last0", "wfp", "b_feat"),
                   x.shape[0], *sdf_geometry(cfg), float(cfg.scale), cfg.d_out,
                   build.n_blocks(x.device), build.stream(x))
    return out


def sdf_out_bwd_cuda(cfg, packed, x: torch.Tensor, obar: torch.Tensor):
    """K7-bwd for the head's cotangent obar (n, d_out) -> (x_bar (n, 4),
    [(W_bar (out, in), b_bar)] per SDF layer)."""
    _check(cfg, packed, x)
    build.check_rows(x, (obar, "obar", cfg.d_out))
    params, offs = packed
    goffs, gsize = sdf_value_grad_layout(cfg, cfg.d_out)
    n, geom = x.shape[0], sdf_geometry(cfg)
    blocks = build.n_blocks(x.device)
    with BWD_COUNTER.launch():
        stage, partial, scratch, grads = build.bwd_buffers(
            "sdf_out_bwd", (n, *geom, cfg.d_out, blocks), gsize, x.device)
        x_bar, = build.outputs(x, 4)
        build.call("sdf_out_bwd", x.data_ptr(), obar.data_ptr(), x_bar.data_ptr(),
                   params.data_ptr(),
                   *offs.c("b", "wp", "wtp", "w_last0", "b_last0", "wftp"),
                   grads.data_ptr(), *goffs.c("gw", "gb"), stage.data_ptr(),
                   partial.data_ptr(), scratch.data_ptr(), n, *geom, float(cfg.scale),
                   cfg.d_out, blocks, build.stream(x))
        bars = unpack_sdf_value_grads(grads, goffs, cfg, cfg.d_out)
    return x_bar, bars


class SdfOut(torch.autograd.Function):
    """out (n, d_out) of x (n, 4); ``packed`` is the outgrad pack
    (``pack.pack_outgrad``) of the inputs after x: the effective W
    (out, in) of every SDF layer, then every b, which carry the
    gradients."""

    @staticmethod
    def forward(ctx, cfg, packed, x, *wb):
        ctx.cfg, ctx.packed = cfg, packed
        ctx.save_for_backward(x)
        return launch_out_fwd(cfg, packed, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, obar):
        x, = ctx.saved_tensors
        obar, = build.cotangents(x, (obar,), (ctx.cfg.d_out,))
        x_bar, bars = sdf_out_bwd_cuda(ctx.cfg, ctx.packed, x, obar)
        return (None, None, x_bar, *build.weight_args(bars))


def sdf_out(net, x: torch.Tensor) -> torch.Tensor:
    """[sdf, feature] (..., d_out) of (..., 4) points, differentiable to
    first order."""
    if x.device.type == "cpu":
        return sdf_out_plain(net, x)
    out = apply_with_cached_pack(SdfOut, (net,), pack_outgrad,
                                 x.reshape(-1, 4).contiguous())
    return out.reshape(x.shape[:-1] + (net.cfg.d_out,))
