"""K2 — the no-grad SDF value sweep (``csrc/sdf_value.cu``).

Replaces ``copenerf_tpu/ops/pallas/sdf_kernels.py`` ``value_kernel``
(``FusedOps.value``). ``sdf_value(net, x)`` routes on the tensor's device:
a CUDA tensor launches the kernel (or raises), a CPU tensor takes
``sdf_value_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import build
from .pack import check_sdf_geometry, pack_sdf_value, sdf_geometry

COUNTER = build.KernelCounter("sdf_value")


def sdf_value_plain(net, x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,): ``sdf_apply(...)[..., 0]`` with the threshold
    softplus, no autograd."""
    with torch.no_grad():
        return net(x)[..., 0]


def launch_value(cfg, packed, x: torch.Tensor,
                 counter: build.KernelCounter) -> torch.Tensor:
    """Launch the value kernel on (n, 4) contiguous f32 CUDA rows with a
    value pack (``pack.pack_sdf_value_layers``) -> (n,); counted on
    ``counter``."""
    check_sdf_geometry(cfg)
    build.check_input(x, "x", cfg.d_in)
    params, offs = packed
    build.check_pack(params, x)
    with counter.launch():
        out, = build.outputs(x, None)
        build.call("sdf_value", x.data_ptr(), out.data_ptr(), params.data_ptr(),
                   *offs.c("b", "wp", "w_last0", "b_last0"), x.shape[0],
                   *sdf_geometry(cfg), float(cfg.scale), build.stream(x))
    return out


def sdf_value_cuda(net, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on (n, 4) contiguous f32 CUDA rows -> (n,)."""
    build.check_input(x, "x", net.cfg.d_in)
    build.check_no_grad([x, *net.parameters()], "sdf_value")
    return launch_value(net.cfg, pack_sdf_value(net), x, COUNTER)


def sdf_value(net, x: torch.Tensor) -> torch.Tensor:
    """SDF value of (..., 4) points -> (...,), no autograd."""
    if x.device.type == "cpu":
        return sdf_value_plain(net, x)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    return sdf_value_cuda(net, flat).reshape(lead)
