"""K4 — the SDF output and its input gradient: K4-fwd
(``csrc/sdf_outgrad_fwd.cu``) and its second-order backward K4-bwd
(``csrc/sdf_outgrad_bwd.cu``).

Replaces ``copenerf_tpu/ops/pallas/sdf_kernels.py`` ``make_fwd_kernel`` /
``make_bwd_kernel`` with ``with_grad=True`` / ``second_order=True``
(``FusedOps.outgrad``): the 257-wide SDF head and d(sdf)/d(x, y, z, t) of
each row, with a backward that carries the cotangent of the gradient
(eikonal, sdf-flow, color through the normal) through the gradient's graph.
The gradient's x-dependence is severed, as the reference detaches the
points before ``gradient()``: x_bar comes from the head's cotangent alone.

``sdf_outgrad(net, x)`` routes on the tensor's device: a CUDA tensor
launches K4-fwd alone when nothing needs a gradient, and otherwise goes
through ``SdfOutGrad`` (an ``autograd.Function`` whose forward launches
K4-fwd and whose backward launches K4-bwd); a CPU tensor takes
``sdf_outgrad_plain``. The Function's inputs are x and the SDF net's
effective weights and biases, so autograd carries the kernel's W-bars
through weight norm, and their outgrad pack, the one cached on the net
that K4-fwd's no-grad launches read.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...models.fields import sdf_output_and_gradient_plain
from . import build
from .pack import (apply_with_cached_pack, check_outgrad_geometry,
                   outgrad_grad_layout, pack_outgrad, sdf_geometry, unpack_outgrad_grads)

FWD_COUNTER = build.KernelCounter("sdf_outgrad_fwd")
BWD_COUNTER = build.KernelCounter("sdf_outgrad_bwd")


# The plain version: the SDF forward, and ``autograd.grad`` of its column 0
# with the input detached (``create_graph`` under grad mode, so the
# second-order terms reach the weights).
sdf_outgrad_plain = sdf_output_and_gradient_plain


def launch_outgrad_fwd(cfg, packed, x: torch.Tensor):
    """K4-fwd on (n, 4) contiguous f32 CUDA rows with an outgrad pack ->
    (out (n, d_out), grad (n, 4))."""
    check_outgrad_geometry(cfg)
    build.check_input(x, "x", 4)
    params, offs = packed
    build.check_pack(params, x)
    n, geom = x.shape[0], sdf_geometry(cfg)
    with FWD_COUNTER.launch():
        out, grad = build.outputs(x, cfg.d_out, 4)
        blocks = build.n_blocks(x.device)
        scratch = torch.empty(blocks * (geom[0] - 1) * 64 * 256, dtype=torch.float32,
                              device=x.device)
        build.call("sdf_outgrad_fwd", x.data_ptr(), out.data_ptr(), grad.data_ptr(),
                   params.data_ptr(),
                   *offs.c("b", "wp", "wtp", "w_last0", "b_last0", "wfp", "b_feat"),
                   scratch.data_ptr(), n, *geom, float(cfg.scale), cfg.d_out, blocks,
                   build.stream(x))
    return out, grad


def sdf_outgrad_cuda(net, x: torch.Tensor):
    """Launch K4-fwd alone (no autograd) on (n, 4) contiguous f32 CUDA rows
    -> (out (n, d_out), grad (n, 4))."""
    build.check_input(x, "x", 4)
    build.check_no_grad([x, *net.parameters()], "sdf_outgrad_fwd")
    return launch_outgrad_fwd(net.cfg, pack_outgrad(net), x)


def outgrad_bwd_cuda(cfg, packed, x, obar, gbar):
    """K4-bwd for the cotangents obar (n, d_out) and gbar (n, 4) ->
    (x_bar (n, 4), [(W_bar (out, in), b_bar)] per SDF layer)."""
    check_outgrad_geometry(cfg)
    build.check_rows(x, (x, "x", 4), (obar, "obar", cfg.d_out), (gbar, "gbar", 4))
    params, offs = packed
    goffs, gsize = outgrad_grad_layout(cfg)
    n, geom = x.shape[0], sdf_geometry(cfg)
    blocks = build.n_blocks(x.device)
    with BWD_COUNTER.launch():
        stage, partial, scratch, grads = build.bwd_buffers(
            "sdf_outgrad_bwd", (n, *geom, cfg.d_out, blocks), gsize, x.device)
        x_bar, = build.outputs(x, 4)
        build.call("sdf_outgrad_bwd", x.data_ptr(), obar.data_ptr(), gbar.data_ptr(),
                   x_bar.data_ptr(), params.data_ptr(),
                   *offs.c("b", "wp", "wtp", "w_last0", "b_last0", "wftp"),
                   grads.data_ptr(), *goffs.c("gw", "gb", "gw_last0"),
                   stage.data_ptr(), partial.data_ptr(), scratch.data_ptr(), n, *geom,
                   float(cfg.scale), cfg.d_out, blocks, build.stream(x))
        bars = unpack_outgrad_grads(grads, goffs, cfg)
    return x_bar, bars


class SdfOutGrad(torch.autograd.Function):
    """(out (n, d_out), grad (n, 4)) of x (n, 4); ``packed`` is the outgrad
    pack (``pack.pack_outgrad``) of the inputs after x: the effective W
    (out, in) of every SDF layer, then every b, which carry the gradients.
    Cotangents that arrive as None count as zeros."""

    @staticmethod
    def forward(ctx, cfg, packed, x, *wb):
        ctx.cfg, ctx.packed = cfg, packed
        ctx.save_for_backward(x)
        return launch_outgrad_fwd(cfg, packed, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, obar, gbar):
        x, = ctx.saved_tensors
        obar, gbar = build.cotangents(x, (obar, gbar), (ctx.cfg.d_out, 4))
        x_bar, bars = outgrad_bwd_cuda(ctx.cfg, ctx.packed, x, obar, gbar)
        return (None, None, x_bar, *build.weight_args(bars))


def sdf_outgrad(net, x: torch.Tensor):
    """(out (..., d_out), grad (..., 4)) of (..., 4) points, differentiable
    wherever grad mode asks for it; grad's x-dependence severed."""
    if x.device.type == "cpu":
        return sdf_outgrad_plain(net, x)
    lead = x.shape[:-1]
    xf = x.reshape(-1, 4).contiguous()
    if build.needs_grad([xf, *net.parameters()]):
        out, grad = apply_with_cached_pack(SdfOutGrad, (net,), pack_outgrad, xf)
    else:
        out, grad = sdf_outgrad_cuda(net, xf)
    return out.reshape(lead + (net.cfg.d_out,)), grad.reshape(lead + (4,))
