"""K3 — the differentiable SDF value: K3-fwd is the value kernel
(``csrc/sdf_value.cu``), K3-bwd its first-order backward
(``csrc/sdf_value_bwd.cu``).

Replaces ``copenerf_tpu/ops/pallas/sdf_kernels.py`` ``make_fwd_kernel`` /
``make_bwd_kernel`` with ``value_only=True`` (``FusedOps.value_diff``), the
sdf-consistency re-query. ``sdf_value_diff(net, x)`` routes on the tensor's
device: a CUDA tensor goes through ``SdfValueDiff`` (an
``autograd.Function`` whose forward launches K3-fwd and whose backward
launches K3-bwd, or raises), a CPU tensor takes ``sdf_value_diff_plain``.
The Function's inputs are x and the SDF net's effective weights and
biases, so autograd carries the kernel's W-bars through weight norm, and
their pack, the one cached on the net that its K2 launches read (built
once a train step).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build
from .pack import (apply_with_cached_pack, check_sdf_geometry, pack_sdf_value,
                   sdf_geometry, sdf_value_grad_layout, unpack_sdf_value_grads)
from .sdf_value import launch_value

FWD_COUNTER = build.KernelCounter("sdf_value_diff_fwd")
BWD_COUNTER = build.KernelCounter("sdf_value_bwd")


def sdf_value_diff_plain(net, x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,): ``net(x)[..., 0]`` under autograd."""
    return net(x)[..., 0]


def sdf_value_bwd_cuda(cfg, packed, x: torch.Tensor, obar: torch.Tensor):
    """Launch K3-bwd on (n, 4) rows and the value cotangent (n,) ->
    (x_bar (n, 4), [(W_bar (out, in), b_bar)] per SDF layer)."""
    check_sdf_geometry(cfg)
    build.check_input(x, "x", 4)
    build.check_input(obar.reshape(-1, 1), "obar", 1)
    params, offs = packed
    goffs, gsize = sdf_value_grad_layout(cfg)
    n, geom = x.shape[0], sdf_geometry(cfg)
    blocks = build.n_blocks(x.device)
    with BWD_COUNTER.launch():
        stage, partial, scratch, grads = build.bwd_buffers(
            "sdf_value_bwd", (n, *geom, blocks), gsize, x.device)
        x_bar, = build.outputs(x, 4)
        build.call("sdf_value_bwd", x.data_ptr(), obar.data_ptr(), x_bar.data_ptr(),
                   params.data_ptr(), *offs.c("b", "wp", "wtp", "w_last0", "b_last0"),
                   grads.data_ptr(), *goffs.c("gw", "gb"), stage.data_ptr(),
                   partial.data_ptr(), scratch.data_ptr(), n, *geom, float(cfg.scale),
                   blocks, build.stream(x))
        bars = unpack_sdf_value_grads(grads, goffs, cfg)
    return x_bar, bars


class SdfValueDiff(torch.autograd.Function):
    """sdf (n,) of x (n, 4); inputs after x: the effective W (out, in) of
    every SDF layer, then every b. ``packed`` is their value pack
    (``pack.pack_sdf_value`` of the net they come from); the kernels read
    it, and the W and b carry the gradients."""

    @staticmethod
    def forward(ctx, cfg, packed, x, *wb):
        ctx.cfg, ctx.packed = cfg, packed
        ctx.save_for_backward(x)
        return launch_value(cfg, packed, x, FWD_COUNTER)

    @staticmethod
    @once_differentiable
    def backward(ctx, obar):
        x, = ctx.saved_tensors
        obar, = build.cotangents(x, (obar,), (None,))
        x_bar, bars = sdf_value_bwd_cuda(ctx.cfg, ctx.packed, x, obar)
        return (None, None, x_bar, *build.weight_args(bars))


def sdf_value_diff(net, x: torch.Tensor) -> torch.Tensor:
    """Differentiable SDF value of (..., 4) points -> (...,)."""
    if x.device.type == "cpu":
        return sdf_value_diff_plain(net, x)
    return apply_with_cached_pack(SdfValueDiff, (net,), pack_sdf_value,
                                  x.reshape(-1, 4).contiguous()).reshape(x.shape[:-1])
