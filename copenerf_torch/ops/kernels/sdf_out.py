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
autograd carries the kernel's W-bars through weight norm.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build
from .pack import (check_outgrad_geometry, effective_layers, pack_outgrad_layers,
                   sdf_geometry, sdf_value_grad_layout, unpack_sdf_value_grads)

FWD_COUNTER = build.KernelCounter("sdf_out_fwd")
BWD_COUNTER = build.KernelCounter("sdf_out_bwd")


def sdf_out_plain(net, x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., d_out): ``sdf_apply`` under autograd."""
    return net(x)


def _check(cfg, packed, x):
    check_outgrad_geometry(cfg)
    build.check_input(x, "x", 4)
    if packed[0].device != x.device:
        raise ValueError(f"weights on {packed[0].device}, x on {x.device}")


def launch_out_fwd(cfg, packed, x: torch.Tensor) -> torch.Tensor:
    """K7-fwd on (n, 4) contiguous f32 CUDA rows with an outgrad pack
    (``pack.pack_outgrad_layers``) -> out (n, d_out)."""
    _check(cfg, packed, x)
    params, offs = packed
    n = x.shape[0]
    with FWD_COUNTER.launch():
        out = torch.empty((n, cfg.d_out), dtype=torch.float32, device=x.device)
        code = build.load_library().copenerf_sdf_out_fwd(
            x.data_ptr(), out.data_ptr(), params.data_ptr(),
            build.offsets(offs["b"]), build.offsets(offs["wp"]),
            offs["w_last0"], offs["b_last0"],
            offs["wfp"], offs["b_feat"], n, *sdf_geometry(cfg),
            float(cfg.scale), cfg.d_out, build.n_blocks(x.device), build.stream(x))
        build.check(code, "sdf_out_fwd")
    return out


def sdf_out_bwd_cuda(cfg, packed, x: torch.Tensor, obar: torch.Tensor):
    """K7-bwd for the head's cotangent obar (n, d_out) -> (x_bar (n, 4),
    [(W_bar (out, in), b_bar)] per SDF layer)."""
    _check(cfg, packed, x)
    build.check_input(obar, "obar", cfg.d_out)
    if obar.shape[0] != x.shape[0]:
        raise ValueError(f"obar: {obar.shape[0]} rows, x has {x.shape[0]}")
    params, offs = packed
    goffs, gsize = sdf_value_grad_layout(cfg, cfg.d_out)
    n, dev = x.shape[0], x.device
    geom = sdf_geometry(cfg)
    blocks = build.n_blocks(dev)
    with BWD_COUNTER.launch():
        lib = build.load_library()
        n_stage, n_part, n_scratch = build.workspace(
            lib.copenerf_sdf_out_bwd_workspace, n, *geom, cfg.d_out, blocks)
        f32 = dict(dtype=torch.float32, device=dev)
        stage = torch.empty(n_stage, **f32)
        partial = torch.empty(n_part, **f32)
        scratch = torch.empty(n_scratch, **f32)
        grads = torch.zeros(gsize, **f32)
        x_bar = torch.empty((n, 4), **f32)
        O = build.offsets
        code = lib.copenerf_sdf_out_bwd(
            x.data_ptr(), obar.data_ptr(), x_bar.data_ptr(), params.data_ptr(),
            O(offs["b"]), O(offs["wp"]), O(offs["wtp"]), offs["w_last0"],
            offs["b_last0"], offs["wftp"], grads.data_ptr(), O(goffs["gw"]),
            O(goffs["gb"]), stage.data_ptr(), partial.data_ptr(),
            scratch.data_ptr(), n, *geom, float(cfg.scale), cfg.d_out, blocks,
            build.stream(x))
        build.check(code, "sdf_out_bwd")
        bars = unpack_sdf_value_grads(grads, goffs, cfg, cfg.d_out)
    return x_bar, bars


class SdfOut(torch.autograd.Function):
    """out (n, d_out) of x (n, 4); inputs after x: the effective W
    (out, in) of every SDF layer, then every b."""

    @staticmethod
    def forward(ctx, cfg, x, *wb):
        n_lin = len(wb) // 2
        packed = pack_outgrad_layers(list(zip(wb[:n_lin], wb[n_lin:])))
        ctx.cfg, ctx.packed = cfg, packed
        ctx.save_for_backward(x)
        return launch_out_fwd(cfg, packed, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, obar):
        x, = ctx.saved_tensors
        x_bar, bars = sdf_out_bwd_cuda(ctx.cfg, ctx.packed, x, obar.contiguous())
        return (None, x_bar, *[w for w, _ in bars], *[b for _, b in bars])


def sdf_out(net, x: torch.Tensor) -> torch.Tensor:
    """[sdf, feature] (..., d_out) of (..., 4) points, differentiable to
    first order."""
    if x.device.type == "cpu":
        return sdf_out_plain(net, x)
    lead = x.shape[:-1]
    ws, bs = zip(*effective_layers(net))
    out = SdfOut.apply(net.cfg, x.reshape(-1, 4).contiguous(), *ws, *bs)
    return out.reshape(lead + (net.cfg.d_out,))
