"""NeuS volume rendering in plain PyTorch, as CoPE-NeRF renders.

Rays from the NDC-style camera matrix; 64 stratified samples; ``up_sample_steps``
rounds of NeuS up-sampling at inv_s 64 * 2^i (section-wise alpha, a
deterministic inverse-CDF draw, a stable merge); the SDF, its input
gradient and the IDR color at the merged samples; alpha from the SDF's
logistic CDF with cos annealing; transmittance-weighted compositing. As
upstream, the inside-sphere mask is all ones and no background is blended.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nets


def rays(p_norm, camera_mat, world_mat, scale_mat):
    """World rays of pixels in [-1, 1]: (origins, unit dirs, dir lengths)."""
    inv = (torch.linalg.inv(scale_mat) @ torch.linalg.inv(world_mat)
           @ torch.linalg.inv(camera_mat))
    n = p_norm.shape[0]
    origin = inv[:3, 3].expand(n, 3)
    p_hom = torch.cat([p_norm, p_norm.new_ones((n, 2))], dim=-1)
    ray = p_hom @ inv[:3, :].T - origin
    norm = torch.linalg.norm(ray, dim=-1, keepdim=True)
    return origin, ray / norm, norm


def pixels(idx, h: int, w: int):
    """Flat pixel indices -> ((x, y) pixels, the same scaled to [-1, 1])."""
    row = torch.div(idx, w, rounding_mode="floor").float()
    col = (idx % w).float()
    p = torch.stack([col, row], dim=-1)
    p_norm = torch.stack([2.0 * col / (w - 1) - 1.0,
                          2.0 * row / (h - 1) - 1.0], dim=-1)
    return p, p_norm


def _transmittance(alpha, eps=1e-7):
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         1.0 - alpha[..., :-1] + eps], dim=-1)
    return torch.cumprod(shifted, dim=-1)


def _sample_pdf(bins, weights, n):
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, dtype=cdf.dtype,
                       device=cdf.device).expand(cdf.shape[:-1] + (n,))
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def _up_sample(z, sdf, n, inv_s):
    mid_sdf = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos[..., :1]), cos[..., :-1]], -1)
    cos = torch.clamp(torch.minimum(prev_cos, cos), -1e3, 0.0)
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid_sdf - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return _sample_pdf(z, alpha * _transmittance(alpha), n)


def _with_time(pts, t):
    t = torch.as_tensor(t, dtype=pts.dtype, device=pts.device)
    return torch.cat([pts, t.reshape(1).expand(pts.shape[:-1] + (1,))], -1)


def render(w, cfg: dict, rays_o, rays_d, rays_d_norm, time_step, near: float,
           far: float, *, cos_anneal_ratio: float, t_rand=None, cons=None,
           precision="f32"):
    """One render of the rays. ``w`` holds the weights (``sdf``, ``color``
    layer lists and the ``variance`` scalar). ``t_rand`` (n, n_samples) is
    the stratified jitter of a training render; None renders at the sample
    grid and returns z-depth. ``cons`` is ``(cw2 (4, 4), world time)``: the
    SDF value at the samples moved by ``cw2`` comes back as ``sdf_world``."""
    r = cfg["neus_renderer"]
    scfg, ccfg = cfg["neus_sdf_network"], cfg["neus_rendering_network"]
    n_s, n_i = r["n_samples"], r["n_importance"]
    n = rays_o.shape[0]
    dev = rays_o.device
    sample_dist = (far - near) / n_s
    t = torch.linspace(0.0, 1.0, n_s, device=dev)
    z = (near * (1.0 - t) + far * t).expand(n, n_s)
    if t_rand is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * t_rand

    def value(zz):
        p = rays_o[:, None] + rays_d[:, None] * zz[..., None]
        return nets.sdf_forward(w["sdf"], scfg, _with_time(p, time_step),
                                precision)[..., 0]

    with torch.no_grad():
        sdf = value(z)
        steps = r["up_sample_steps"]
        for i in range(steps):
            new_z = _up_sample(z, sdf, n_i // steps, 64.0 * 2 ** i)
            z_cat = torch.cat([z, new_z], -1)
            z, order = torch.sort(z_cat, dim=-1, stable=True)
            if i + 1 < steps:
                sdf = torch.gather(torch.cat([sdf, value(new_z)], -1), -1,
                                   order)

    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], sample_dist)], -1)
    mid_z = z + dists * 0.5
    pts = rays_o[:, None] + rays_d[:, None] * mid_z[..., None]
    dirs = rays_d[:, None].expand(pts.shape)
    x = _with_time(pts, time_step)
    out, grad = nets.sdf_value_and_grad(w["sdf"], scfg, x, precision)
    sdf = out[..., :1]
    color_s = nets.color_forward(w["color"], ccfg, x, grad, dirs, out[..., 1:],
                                 precision)
    result = {}
    if cons is not None:
        cw2, world_t = cons
        pw = pts @ cw2[:3, :3].T + cw2[:3, 3]
        result["sdf_world"] = nets.sdf_forward(
            w["sdf"], scfg, _with_time(pw, world_t), precision)[..., 0]
    normals = grad[..., :3]
    inv_s = torch.clamp(torch.exp(w["variance"] * 10.0), 1e-3, 1e3)
    true_cos = torch.sum(dirs * normals, dim=-1, keepdim=True)
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + F.relu(-true_cos) * cos_anneal_ratio)
    prev_cdf = torch.sigmoid((sdf - iter_cos * dists[..., None] * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * dists[..., None] * 0.5) * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5)
                         / (prev_cdf + 1e-5))[..., 0], 0.0, 1.0)
    weights = alpha * _transmittance(alpha)
    depth = torch.sum(z * weights, dim=1, keepdim=True)
    result.update(
        color=torch.sum(color_s * weights[..., None], dim=1),
        depth=depth if t_rand is not None else depth / rays_d_norm,
        weighted_z=depth.detach(), weights=weights, normals=normals,
        sdf_flows=grad[..., 3:], sdf=sdf[..., 0], points=pts)
    return result
