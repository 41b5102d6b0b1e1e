"""Hierarchical importance sampling along rays (port of
``copenerf_tpu/ops/sampling.py``).

The JAX package's one-hot MXU gather and broadcast searchsorted were TPU
layout choices; here they are ``torch.gather`` and
``torch.searchsorted(right=True)``. Its bitonic merge becomes a stable
``torch.sort`` of the concatenation plus a gather: equal except at exact z
ties.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def sample_pdf(bins, weights, n_samples: int, *, u=None, prepend_zero=True):
    """Inverse-CDF sampling. ``u`` defaults to the deterministic midpoint
    grid. bins: (B, S) sorted sample positions; weights: (B, S-1) (or (B, S)
    with ``prepend_zero=False``)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    if prepend_zero:
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(cdf.shape[:-1] + (n_samples,))
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


class _NonzeroCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last dim of factors none of which is 0,
    with the gradient autograd's own ``cumprod`` backward gives for such
    factors, the same operations in the same order: the reversed
    cumulative sum of output x cotangent, over the factors. Autograd's
    backward first reads on the host whether any factor is 0, which makes
    the host wait for the card."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def _exclusive_transmittance(alpha: torch.Tensor, eps: float = 1e-7):
    """T_i = prod_{j<i} (1 - alpha_j + eps); alpha in [0, 1], so every
    factor is at least eps."""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         1.0 - alpha[..., :-1] + eps], dim=-1)
    return _NonzeroCumprod.apply(shifted)


def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int, inv_s: float):
    """One NeuS up-sampling round: section-wise alpha at fixed inv_s ->
    weights -> deterministic inverse-CDF draw of ``n_importance`` new z."""
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    # min(cos, previous cos), clipped non-positive (the reference's
    # inside_sphere mask is overwritten with ones, so it is omitted).
    prev_cos = torch.cat([torch.zeros_like(cos_val[..., :1]),
                          cos_val[..., :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0)

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = alpha * _exclusive_transmittance(alpha)
    return sample_pdf(z_vals, weights, n_importance).detach()


def logistic_density(x, s):
    e = torch.exp(-s * x)
    return s * e / (1.0 + e) ** 2


def up_sample_naive(rays_o, rays_d, z_vals, sdf, n_importance: int,
                    inv_s: float):
    """Logistic-density variant: alpha is the logistic pdf of the sdf at
    scale 1/inv_s; inverse-CDF without the zero prepend."""
    alpha = logistic_density(sdf, 1.0 / inv_s)
    weights = alpha * _exclusive_transmittance(alpha)
    return sample_pdf(z_vals, weights, n_importance,
                      prepend_zero=False).detach()


def cat_z_vals(z_vals, new_z_vals, sdf, new_sdf=None):
    """Merge z values and co-permute sdf into the merged (stably sorted)
    order. Returns (z_sorted, sdf_sorted, order); when ``new_sdf`` is None
    (last round) sdf is returned unchanged."""
    z_cat = torch.cat([z_vals, new_z_vals], dim=-1)
    z_sorted, order = torch.sort(z_cat, dim=-1, stable=True)
    if new_sdf is None:
        return z_sorted, sdf, order
    sdf_sorted = torch.gather(torch.cat([sdf, new_sdf], dim=-1), -1, order)
    return z_sorted, sdf_sorted, order
