"""Rotation-representation conversions (port of
``copenerf_tpu/poses/rotations.py``).

PyTorch3D conventions: for "XYZ", ``euler_angles_to_matrix`` returns
Rx @ Ry @ Rz; quaternions are (w, x, y, z).
"""

from __future__ import annotations

import torch


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(axis)
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ"):
    """(..., 3) Euler angles -> (..., 3, 3)."""
    mats = [_axis_rotation(axis, euler[..., i])
            for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _index_from_letter(letter: str) -> int:
    return {"X": 0, "Y": 1, "Z": 2}[letter]


def _angle_from_tan(axis, other_axis, data, horizontal, tait_bryan):
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str = "XYZ"):
    """(..., 3, 3) -> (..., 3) Euler angles (PyTorch3D semantics)."""
    i0 = _index_from_letter(convention[0])
    i2 = _index_from_letter(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(matrix[..., i0, i2]
                             * (-1.0 if i0 - i2 in [-1, 2] else 1.0))
    else:
        central = torch.acos(matrix[..., i0, i0])
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False,
                        tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True,
                        tait_bryan),
    )
    return torch.stack(o, dim=-1)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z)."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]

    def sqrt_pos(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    w = 0.5 * sqrt_pos(1 + m00 + m11 + m22)
    x = 0.5 * sqrt_pos(1 + m00 - m11 - m22)
    y = 0.5 * sqrt_pos(1 - m00 + m11 - m22)
    z = 0.5 * sqrt_pos(1 - m00 - m11 + m22)
    x = torch.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = torch.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = torch.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    return torch.stack([w, x, y, z], dim=-1)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3) axis-angle."""
    norms = torch.linalg.norm(quat[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quat[..., :1])
    angles = 2.0 * half_angles
    small = torch.abs(angles) < 1e-6
    sin_half_over = torch.where(
        small, 0.5 - angles * angles / 48.0,
        torch.sin(half_angles) / torch.where(small, torch.ones_like(angles),
                                             angles))
    return quat[..., 1:] / sin_half_over


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))
