"""Bilinear image sampling (port of ``copenerf_tpu/ops/interp.py``).

``torch.nn.functional.grid_sample(mode='bilinear', padding_mode='border',
align_corners=True)`` semantics as the reference's photometric warping uses
them: coords in [-1, 1] map linearly onto [0, W-1] x [0, H-1], out-of-range
coords clamp to the border. Written out as the JAX package does (clamp, floor
clamped to W-2 / H-2, weights x - x0) so that the gradient with respect to
the coordinates matches it at the border too.
"""

from __future__ import annotations

import torch


def _clip(v: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.clip(v, 0, hi)`` with its gradient: max / min split a tie, so
    a coordinate exactly on the border gets half the slope (``clamp`` would
    pass all of it)."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), hi))


def grid_sample_bilinear(image: torch.Tensor, coords: torch.Tensor):
    """Sample ``image`` (C, H, W) at ``coords`` (N, 2) in [-1, 1] (x, y).
    Returns (N, C)."""
    return grid_sample_bilinear_batched(image[None], coords[None])[0].T


def grid_sample_bilinear_batched(images: torch.Tensor,
                                 coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample_bilinear`` over a batch: ``images`` (B, C, H, W) each
    sampled at its own ``coords`` (B, N, 2). Returns (B, C, N); each corner
    is one gather over the (B, C, H * W) images."""
    b, c, h, w = images.shape
    x = _clip((coords[..., 0] + 1.0) * 0.5 * (w - 1), w - 1)
    y = _clip((coords[..., 1] + 1.0) * 0.5 * (h - 1), h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    flat = images.reshape(b, c, h * w)

    def gather(yy, xx):
        return torch.gather(flat, 2, (yy * w + xx)[:, None].expand(b, c, -1))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def warp_pixels(image: torch.Tensor, uv: torch.Tensor, normalize: bool = True):
    """Reference ``Trainer.warp_pixel``: ``uv`` (N, 2) in pixel units when
    ``normalize``; returns (N, C) sampled colors."""
    _, h, w = image.shape
    if normalize:
        uv = torch.stack([uv[:, 0] / ((w - 1) / 2.0) - 1.0,
                          uv[:, 1] / ((h - 1) / 2.0) - 1.0], dim=-1)
    return grid_sample_bilinear(image, uv)
