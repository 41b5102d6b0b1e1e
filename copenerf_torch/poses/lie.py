"""SO(3)/SE(3) helpers (port of ``copenerf_tpu/poses/lie.py``): ``vec2skew``,
Rodrigues ``exp_so3`` with a Taylor branch at the origin, ``make_c2w`` and
the closed-form ``se3_inverse``."""

from __future__ import annotations

import torch

from ..utils.tensors import constant


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1)]
    return torch.stack(rows, dim=-2)


def exp_so3(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues); the
    coefficients switch to Taylor expansions below |r| = 1e-3."""
    skew = vec2skew(r)
    sq = torch.sum(r * r, dim=-1)[..., None, None]
    small = sq < 1e-6
    one = torch.ones_like(sq)
    safe_n = torch.sqrt(torch.where(small, one, sq))
    coeff_a = torch.where(small, 1.0 - sq / 6.0, torch.sin(safe_n) / safe_n)
    coeff_b = torch.where(small, 0.5 - sq / 24.0,
                          (1.0 - torch.cos(safe_n)) / torch.where(small, one, sq))
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(skew.shape)
    return eye + coeff_a * skew + coeff_b * (skew @ skew)


def bottom_row(top: torch.Tensor) -> torch.Tensor:
    """The rows [0, 0, 0, 1] under (..., 3, 4) ``top``: (..., 1, 4)."""
    row = constant((0.0, 0.0, 0.0, 1.0), top.dtype, top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def make_c2w(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) + translation (..., 3) -> SE(3) (..., 4, 4)."""
    top = torch.cat([exp_so3(r), t[..., :, None]], dim=-1)
    return torch.cat([top, bottom_row(top)], dim=-2)


def se3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    rot_t = m[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -rot_t @ m[..., :3, 3:]], dim=-1)
    return torch.cat([top, bottom_row(top)], dim=-2)
