"""Image metrics: PSNR, SSIM (CF3DGS-compatible) and LPIPS (port of
``copenerf_tpu/evaluation/metrics_image.py``).

PSNR and SSIM follow the reference's ``co3d_metric.py``: a per-image mean
over an 11x11 Gaussian window (sigma 1.5) with zero same-padding. Both take
``(C, H, W)`` tensors on any device and compute in their dtype (f32 for the
evaluator, f64 for the tests' yardsticks).

Every convolution of the metrics runs in exact f32 whatever the caller set:
``exact_f32`` turns cuDNN's TF32 off for the block and restores the caller's
setting after. PyTorch's default lets cuDNN convolutions run in TF32, whose
10-bit mantissa wrecks the moment cancellation E[x^2] - E[x]^2 of SSIM (the
JAX package saw SSIM 1.10 from negative window variances on a TPU's bf16
pass) and moves LPIPS's 13 VGG layers far past f32 rounding.

LPIPS resolves only the port's own implementation (``lpips_torch``) from
the npz pack both packages share; without it ``lpips_fn`` warns and returns
None. It never falls back to another network or to a download.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """cuDNN convolutions in f32, not TF32, inside the block; the caller's
    setting is restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(C, H, W) images in [0, 1] -> scalar PSNR (co3d_metric.py:14-16)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(k, k) normalized Gaussian, built in float64 and cast to f32."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """(C, H, W) -> scalar mean SSIM with per-channel Gaussian filtering and
    zero same-padding (co3d_metric.py:18-48): one depthwise ``F.conv2d``
    (``groups=C``) per moment, in exact f32."""
    c = img1.shape[0]
    window = torch.from_numpy(gaussian_window(window_size)).to(
        device=img1.device, dtype=img1.dtype)
    weight = window.expand(c, 1, window_size, window_size)

    def conv(img):
        return F.conv2d(img[None], weight, padding=window_size // 2,
                        groups=c)[0]

    with exact_f32():
        mu1 = conv(img1)
        mu2 = conv(img2)
        mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
        sigma1 = conv(img1 * img1) - mu1_sq
        sigma2 = conv(img2 * img2) - mu2_sq
        sigma12 = conv(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    return torch.mean(ssim_map)


def lpips_fn(verbose: bool = True, device="cuda"):
    """A callable ``(img1, img2) -> float`` LPIPS(vgg) on ``device`` for
    (3, H, W) tensors or arrays, or None when the weight pack is missing or
    unreadable. A missing metric is reported, never silently dropped."""

    def report(msg):
        if verbose:
            warnings.warn(f"LPIPS unavailable: {msg}", stacklevel=2)

    from .lpips_torch import default_weight_paths, lpips_fn_torch

    try:
        fn = lpips_fn_torch(device)
    except Exception as exc:  # weight files present but unreadable
        report(f"failed to load the weights: {exc!r}")
        return None
    if fn is None:
        vgg, lin = default_weight_paths()
        report(
            "no VGG16/linear-head weights found "
            f"(vgg={vgg!r}, lin={lin!r}); set COPENERF_LPIPS_VGG / "
            "COPENERF_LPIPS_LIN or place them under "
            "~/.cache/copenerf_tpu/lpips/ (python -m "
            "copenerf_torch.evaluation.lpips_export writes the pack)")
    return fn
