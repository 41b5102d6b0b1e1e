"""Per-camera pose correction on top of frozen init poses (port of
``copenerf_tpu/poses/retriever.py``): pose(i) = SE3(exp(r_i), t_i) @
init_c2w_i, with the corrections as ``{"r": (N, 3), "t": (N, 3)}``."""

from __future__ import annotations

import torch

from ..device import resolve_device
from .lie import make_c2w


def pose_retriever_init(num_cams: int, init_c2w=None, device="cuda") -> tuple:
    dev = resolve_device(device)
    params = {"r": torch.zeros((num_cams, 3), dtype=torch.float32, device=dev),
              "t": torch.zeros((num_cams, 3), dtype=torch.float32, device=dev)}
    if init_c2w is None:
        init_c2w = torch.eye(4, dtype=torch.float32).expand(num_cams, 4, 4)
    return params, torch.as_tensor(init_c2w, dtype=torch.float32).to(dev)


def pose_retriever_apply(params: dict, init_c2w: torch.Tensor, cam_id):
    """Pose for one camera id."""
    corr = make_c2w(params["r"][cam_id], params["t"][cam_id])
    return corr @ init_c2w[cam_id]


def pose_retriever_all(params: dict, init_c2w: torch.Tensor) -> torch.Tensor:
    """All (N, 4, 4) poses in one batched op."""
    return make_c2w(params["r"], params["t"]) @ init_c2w
