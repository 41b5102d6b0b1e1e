"""Pixel grids and ray construction (port of ``copenerf_tpu/ops/rays.py``).

The camera matrix is the reference's NDC-style K
    [[2 fx / W, 0, 0, 0], [0, -2 fy / H, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]];
rays come from inverse(scale) @ inverse(world) @ inverse(camera).
"""

from __future__ import annotations

import numpy as np
import torch


def arange_pixels(resolution, image_range=(-1.0, 1.0)):
    """Return (pixel_locations (H*W, 2) int64, pixel_scaled (H*W, 2) f32).

    Row-major scan; each entry is (x, y) = (col, row).
    """
    h, w = resolution
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    loc = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.int64)
    scale = image_range[1] - image_range[0]
    shift = scale / 2.0
    scaled = loc.astype(np.float32).copy()
    scaled[:, 0] = scale * scaled[:, 0] / (w - 1) - shift
    scaled[:, 1] = scale * scaled[:, 1] / (h - 1) - shift
    return loc, scaled


def _inverse(m: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.inv(m)`` without its error check: the same values."""
    return torch.linalg.inv_ex(m, check_errors=False).inverse


def rays_from_pixels(pixels, camera_mat, world_mat, scale_mat):
    """World-space rays for scaled pixel coords.

    Args:
      pixels: (N, 2) scaled pixel coordinates in [-1, 1].
      camera_mat, world_mat, scale_mat: (4, 4) matrices on the same device
        (non-inverted; they are inverted here, with no check that they are
        invertible: ``torch.linalg.inv``'s check reads its result on the
        host, and so waits for the card).

    Returns:
      rays_o (N, 3), rays_d (N, 3) unit directions, rays_d_norm (N, 1) the
      pre-normalization direction length (converts distance -> depth).
    """
    inv = _inverse(scale_mat) @ _inverse(world_mat) @ _inverse(camera_mat)
    n = pixels.shape[0]
    origin = inv[:3, 3]
    camera_world = origin.expand(n, 3)
    p_hom = torch.cat([pixels, torch.ones((n, 2), dtype=pixels.dtype,
                                          device=pixels.device)], dim=-1)
    pixels_world = p_hom @ inv[:3, :].T
    ray = pixels_world - camera_world
    norm = torch.linalg.norm(ray, dim=-1, keepdim=True)
    return camera_world, ray / norm, norm


def near_far_from_depth_range(n: int, depth_range, device="cuda") -> tuple:
    """Constant near/far planes of shape (n, 1)."""
    near = torch.full((n, 1), float(depth_range[0]), dtype=torch.float32,
                      device=device)
    far = torch.full((n, 1), float(depth_range[1]), dtype=torch.float32,
                     device=device)
    return near, far
