"""Continuous camera-motion integration, forward form (port of
``copenerf_tpu/poses/motion.py``).

All (frame, substep) motion-MLP queries run as one batched forward. The
Euler composition over substeps is a Python loop vectorized over frames
(the JAX package's ``lax.scan``), and the frame chain is a sequential
product in the same ``b @ a`` order (its ``associative_scan``; equal by
associativity up to rounding). Substep times match the reference:
``t_k = linspace(t_i, t_{i+1}, S+1)[:-1]`` with ``t_i = i/(N-1)*2-1``.
"""

from __future__ import annotations

import torch

from ..utils.tensors import take
from .lie import bottom_row, se3_inverse
from .rotations import euler_angles_to_matrix


def consecutive_relative_poses(motion_net, n_images: int,
                               nb_sample_timestep: int) -> torch.Tensor:
    """(n_images - 1, 4, 4) relative poses: frame i -> frame i+1."""
    dev = next(motion_net.parameters()).device
    n_int = n_images - 1
    s = nb_sample_timestep
    dt = 2.0 / (n_int * s)
    t0 = torch.arange(n_int, dtype=torch.float32, device=dev) / n_int * 2.0 - 1.0
    times = t0[:, None] + dt * torch.arange(s, dtype=torch.float32,
                                            device=dev)[None, :]
    omega, vel = motion_net(times.reshape(-1, 1))
    r_steps = euler_angles_to_matrix(omega.reshape(n_int, s, 3) * dt, "XYZ")
    v_steps = vel.reshape(n_int, s, 3) * dt

    rot = torch.eye(3, dtype=torch.float32, device=dev).expand(n_int, 3, 3)
    trans = torch.zeros((n_int, 3), dtype=torch.float32, device=dev)
    for k in range(s):
        r_t = r_steps[:, k]
        trans = (r_t @ trans[..., None])[..., 0] + v_steps[:, k]
        rot = rot @ r_t

    top = torch.cat([rot, trans[..., None]], dim=-1)
    return torch.cat([top, bottom_row(top)], dim=-2)


def w2c_mappings(relative_poses: torch.Tensor) -> torch.Tensor:
    """Chain (M, 4, 4) consecutive relative poses into (M + 1, 4, 4)
    world->camera maps, world = first camera:
    ``w2c_k = rel_{k-1} @ ... @ rel_0`` with ``w2c_0 = I``."""
    eye = torch.eye(4, dtype=relative_poses.dtype,
                    device=relative_poses.device)
    out = [eye]
    for k in range(relative_poses.shape[0]):
        out.append(relative_poses[k] @ out[-1])
    return torch.stack(out, dim=0)


def full_video_w2c(motion_net, n_images: int,
                   nb_sample_timestep: int) -> torch.Tensor:
    """(n_images, 4, 4) world(=frame 0)->camera maps for every frame."""
    return w2c_mappings(consecutive_relative_poses(
        motion_net, n_images, nb_sample_timestep))


def relative_pose(w2c_all: torch.Tensor, src_idx, dst_idx) -> torch.Tensor:
    """Transform taking coords of camera ``src`` to camera ``dst``."""
    return take(w2c_all, dst_idx) @ se3_inverse(take(w2c_all, src_idx))


def w2c_from_anchor(w2c_all: torch.Tensor, anchor_idx) -> torch.Tensor:
    """Re-anchor all world->cam maps so ``anchor`` becomes the world frame."""
    return w2c_all @ se3_inverse(take(w2c_all, anchor_idx))[None]
