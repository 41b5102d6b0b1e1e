"""K1-fwd — the render-core field query, forward only
(``csrc/rendercore_fwd.cu``).

Replaces ``copenerf_tpu/ops/pallas/rendercore_kernels.py`` ``fwd_kernel``
(``get_fused_rendercore``): SDF value, its input gradient and the IDR color
in one launch, the 256-wide feature kept on chip. ``rendercore_fwd`` routes
on the tensor's device: CUDA launches the kernel (or raises), CPU takes
``rendercore_fwd_plain``. The backward kernel (and the autograd.Function
around both) lands with the training slice.
"""

from __future__ import annotations

import torch

from ...models.fields import color_apply, sdf_output_and_gradient
from . import build
from .pack import (check_color_geometry, check_sdf_geometry, color_k0,
                   pack_rendercore, sdf_skip)

COUNTER = build.KernelCounter("rendercore_fwd")


def rendercore_fwd_plain(sdf_net, color_net, x: torch.Tensor,
                         dirs: torch.Tensor):
    """The composed path: SDF forward, ``autograd.grad`` with the input
    detached, color MLP. Returns (sdf (...,1), grad (...,4), color (...,3))."""
    out, grad = sdf_output_and_gradient(sdf_net, x)
    color = color_apply(color_net, x, grad, dirs, out[..., 1:])
    return out[..., :1], grad, color


def scratch_blocks(device) -> int:
    """Blocks of the kernel's persistent grid: one per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def rendercore_fwd_cuda(sdf_net, color_net, x: torch.Tensor,
                        dirs: torch.Tensor):
    """Launch the kernel on (n, 4) points and (n, 3) dirs, contiguous f32
    CUDA -> (sdf (n, 1), grad (n, 4), color (n, 3))."""
    scfg, ccfg = sdf_net.cfg, color_net.cfg
    check_sdf_geometry(scfg)
    check_color_geometry(scfg, ccfg)
    build.check_input(x, "x", 4)
    build.check_input(dirs, "dirs", 3)
    if dirs.shape[0] != x.shape[0] or dirs.device != x.device:
        raise ValueError("x and dirs must have the same rows and device")
    build.check_no_grad([x, dirs, *sdf_net.parameters(),
                         *color_net.parameters()], "rendercore_fwd")
    params, offs = pack_rendercore(sdf_net, color_net)
    if params.device != x.device:
        raise ValueError(f"weights on {params.device}, x on {x.device}")
    n = x.shape[0]
    dev = x.device
    sdf = torch.empty((n, 1), dtype=torch.float32, device=dev)
    grad = torch.empty((n, 4), dtype=torch.float32, device=dev)
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    n_blocks = scratch_blocks(dev)
    n_lin = len(scfg.dims) - 1
    scratch = torch.empty(n_blocks * (n_lin - 1) * 64 * 256,
                          dtype=torch.float32, device=dev)
    lib = build.load_library()
    code = lib.copenerf_rendercore_fwd(
        x.data_ptr(), dirs.data_ptr(), sdf.data_ptr(), grad.data_ptr(),
        color.data_ptr(), params.data_ptr(), build.offsets(offs["w"]),
        build.offsets(offs["b"]), build.offsets(offs["wt"]), offs["w_last0"],
        offs["b_last0"], offs["w_feat"], offs["b_feat"],
        build.offsets(offs["wc"]), build.offsets(offs["bc"]),
        scratch.data_ptr(), n,
        n_lin, scfg.d_in, scfg.multires, scfg.d_hidden, sdf_skip(scfg),
        float(scfg.scale), ccfg.d_feature, len(ccfg.dims) - 1,
        ccfg.d_hidden, ccfg.multires_view, color_k0(ccfg),
        int(ccfg.squeeze_out), n_blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "rendercore_fwd")
    COUNTER.launches += 1
    return sdf, grad, color


def rendercore_fwd(sdf_net, color_net, x: torch.Tensor, dirs: torch.Tensor):
    """(sdf (...,1), grad (...,4), color (...,3)) of (..., 4) points and
    (..., 3) view dirs."""
    if x.device.type == "cpu":
        return rendercore_fwd_plain(sdf_net, color_net, x, dirs)
    lead = x.shape[:-1]
    sdf, grad, color = rendercore_fwd_cuda(
        sdf_net, color_net, x.reshape(-1, 4), dirs.reshape(-1, 3))
    return (sdf.reshape(lead + (1,)), grad.reshape(lead + (4,)),
            color.reshape(lead + (3,)))
