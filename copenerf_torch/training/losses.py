"""Loss functions (port of ``copenerf_tpu/training/losses.py``): the
reference's smoothness variants and the inline loss math of its train
step."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smoothness_loss(patches: torch.Tensor) -> torch.Tensor:
    """4-direction L1 depth smoothness over (P, ps, ps, 1) patches."""
    l1 = torch.mean(torch.abs(patches[:, :, :-1] - patches[:, :, 1:]))
    l2 = torch.mean(torch.abs(patches[:, :-1, :] - patches[:, 1:, :]))
    l3 = torch.mean(torch.abs(patches[:, :-1, :-1] - patches[:, 1:, 1:]))
    l4 = torch.mean(torch.abs(patches[:, 1:, :-1] - patches[:, :-1, 1:]))
    return (l1 + l2 + l3 + l4) / 4.0


def edge_aware_smoothness_loss(patches: torch.Tensor, rgb: torch.Tensor,
                               gamma: float = 0.1) -> torch.Tensor:
    """Smoothness weighted by exp(-|dI|_1 / gamma); patches (P, ps, ps, 1)
    depth, rgb (P, ps, ps, 3)."""
    def bf(d):
        return torch.exp(-torch.sum(torch.abs(d), dim=-1) / gamma)[..., None]

    w1 = bf(rgb[:, :, :-1] - rgb[:, :, 1:])
    w2 = bf(rgb[:, :-1, :] - rgb[:, 1:, :])
    w3 = bf(rgb[:, :-1, :-1] - rgb[:, 1:, 1:])
    w4 = bf(rgb[:, 1:, :-1] - rgb[:, :-1, 1:])
    l1 = torch.mean(torch.abs(w1 * (patches[:, :, :-1] - patches[:, :, 1:])))
    l2 = torch.mean(torch.abs(w2 * (patches[:, :-1, :] - patches[:, 1:, :])))
    l3 = torch.mean(torch.abs(w3 * (patches[:, :-1, :-1] - patches[:, 1:, 1:])))
    l4 = torch.mean(torch.abs(w4 * (patches[:, 1:, :-1] - patches[:, :-1, 1:])))
    return (l1 + l2 + l3 + l4) / 4.0


def rgb_l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """sum |pred - gt| / n_rays."""
    return torch.sum(torch.abs(pred - gt)) / pred.shape[0]


def eikonal_loss(normals: torch.Tensor) -> torch.Tensor:
    """mean (||n|| - 1)^2 over all samples."""
    n = normals.reshape(-1, 3)
    return torch.mean((torch.linalg.norm(n, dim=-1) - 1.0) ** 2)


def sdf_flow_loss(scene_flow, normals, sdf_flows, weights,
                  weight_sum=None) -> torch.Tensor:
    """|<flow, n> + d(sdf)/dt| weighted by the detached render weights.
    ``weight_sum`` replaces the sum of the weights in the denominator (the
    data-parallel step passes the sum over every rank's rays)."""
    w = weights.reshape(-1).detach()
    lhs = torch.sum(scene_flow * normals.reshape(-1, 3), dim=-1)
    if weight_sum is None:
        weight_sum = torch.sum(w)
    return torch.sum(torch.abs(lhs + sdf_flows.reshape(-1)) * w) / (
        weight_sum + 1e-10)


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Monodepth-style SSIM loss over (C, H, W) images: 3x3 average pooling
    with reflection padding (unused by the reference's training loss)."""
    def avg_pool3(img):
        return F.avg_pool2d(F.pad(img[None], (1, 1, 1, 1), mode="reflect"),
                            3, stride=1)[0]

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = avg_pool3(x), avg_pool3(y)
    sig_x = avg_pool3(x * x) - mu_x ** 2
    sig_y = avg_pool3(y * y) - mu_y ** 2
    sig_xy = avg_pool3(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    d = (mu_x ** 2 + mu_y ** 2 + c1) * (sig_x + sig_y + c2)
    return torch.clamp((1 - n / d) / 2, 0, 1)
