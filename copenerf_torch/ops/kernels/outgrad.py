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
through weight norm.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...models.fields import sdf_output_and_gradient_plain
from . import build
from .pack import (check_outgrad_geometry, effective_layers, outgrad_grad_layout,
                   pack_outgrad, pack_outgrad_layers, sdf_geometry,
                   unpack_outgrad_grads)

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
    if params.device != x.device:
        raise ValueError(f"weights on {params.device}, x on {x.device}")
    n, dev = x.shape[0], x.device
    with FWD_COUNTER.launch():
        f32 = dict(dtype=torch.float32, device=dev)
        out = torch.empty((n, cfg.d_out), **f32)
        grad = torch.empty((n, 4), **f32)
        blocks = build.n_blocks(dev)
        geom = sdf_geometry(cfg)
        scratch = torch.empty(blocks * (geom[0] - 1) * 64 * 256, **f32)
        O = build.offsets
        code = build.load_library().copenerf_sdf_outgrad_fwd(
            x.data_ptr(), out.data_ptr(), grad.data_ptr(), params.data_ptr(),
            O(offs["b"]), O(offs["wp"]), O(offs["wtp"]),
            offs["w_last0"], offs["b_last0"], offs["wfp"], offs["b_feat"],
            scratch.data_ptr(), n,
            *geom, float(cfg.scale), cfg.d_out, blocks, build.stream(x))
        build.check(code, "sdf_outgrad_fwd")
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
    for t, name, w in ((x, "x", 4), (obar, "obar", cfg.d_out), (gbar, "gbar", 4)):
        build.check_input(t, name, w)
        if t.shape[0] != x.shape[0]:
            raise ValueError(f"{name}: {t.shape[0]} rows, x has {x.shape[0]}")
    params, offs = packed
    goffs, gsize = outgrad_grad_layout(cfg)
    n, dev = x.shape[0], x.device
    blocks = build.n_blocks(dev)
    geom = sdf_geometry(cfg)
    with BWD_COUNTER.launch():
        lib = build.load_library()
        n_stage, n_part, n_scratch = build.workspace(
            lib.copenerf_sdf_outgrad_bwd_workspace, n, *geom, cfg.d_out, blocks)
        f32 = dict(dtype=torch.float32, device=dev)
        stage = torch.empty(n_stage, **f32)
        partial = torch.empty(n_part, **f32)
        scratch = torch.empty(n_scratch, **f32)
        grads = torch.zeros(gsize, **f32)
        x_bar = torch.empty((n, 4), **f32)
        O = build.offsets
        code = lib.copenerf_sdf_outgrad_bwd(
            x.data_ptr(), obar.data_ptr(), gbar.data_ptr(), x_bar.data_ptr(),
            params.data_ptr(), O(offs["b"]), O(offs["wp"]),
            O(offs["wtp"]), offs["w_last0"], offs["b_last0"], offs["wftp"],
            grads.data_ptr(),
            O(goffs["gw"]), O(goffs["gb"]), goffs["gw_last0"], stage.data_ptr(),
            partial.data_ptr(), scratch.data_ptr(), n, *geom, float(cfg.scale),
            cfg.d_out, blocks, build.stream(x))
        build.check(code, "sdf_outgrad_bwd")
        bars = unpack_outgrad_grads(grads, goffs, cfg)
    return x_bar, bars


class SdfOutGrad(torch.autograd.Function):
    """(out (n, d_out), grad (n, 4)) of x (n, 4); inputs after x: the
    effective W (out, in) of every SDF layer, then every b. Cotangents that
    arrive as None count as zeros."""

    @staticmethod
    def forward(ctx, cfg, x, *wb):
        n_lin = len(wb) // 2
        packed = pack_outgrad_layers(list(zip(wb[:n_lin], wb[n_lin:])))
        ctx.cfg, ctx.packed = cfg, packed
        ctx.save_for_backward(x)
        return launch_outgrad_fwd(cfg, packed, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, obar, gbar):
        x, = ctx.saved_tensors
        cfg = ctx.cfg
        obar, gbar = [torch.zeros((x.shape[0], w), dtype=x.dtype, device=x.device)
                      if c is None else c.contiguous()
                      for c, w in ((obar, cfg.d_out), (gbar, 4))]
        x_bar, bars = outgrad_bwd_cuda(cfg, ctx.packed, x, obar, gbar)
        return (None, x_bar, *[w for w, _ in bars], *[b for _, b in bars])


def sdf_outgrad(net, x: torch.Tensor):
    """(out (..., d_out), grad (..., 4)) of (..., 4) points, differentiable
    wherever grad mode asks for it; grad's x-dependence severed."""
    if x.device.type == "cpu":
        return sdf_outgrad_plain(net, x)
    lead = x.shape[:-1]
    xf = x.reshape(-1, 4).contiguous()
    if build.needs_grad([x, *net.parameters()]):
        ws, bs = zip(*effective_layers(net))
        out, grad = SdfOutGrad.apply(net.cfg, xf, *ws, *bs)
    else:
        out, grad = sdf_outgrad_cuda(net, xf)
    return out.reshape(lead + (net.cfg.d_out,)), grad.reshape(lead + (4,))
