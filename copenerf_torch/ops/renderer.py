"""NeuS-style volume renderer (port of ``copenerf_tpu/ops/renderer.py``),
differentiable where grad mode is on.

Plain functions on tensors. ``fields`` is the ``ModuleDict`` of networks
(``models.fields.init_all_fields``); every network carries its own config.

  * importance pre-sampling is gradient-free (4 value sweeps: 64, then
    3 x 16 samples per ray), through ``sdf_value_nograd`` — the value-sweep
    kernel for CUDA tensors;
  * the field query at the 128 final samples is ONE render-core op
    (``sdf_grad_color``): SDF value, its input gradient and the IDR color;
    with ``cons`` it also queries the differentiable SDF value at the
    sdf-consistency world transform of the samples (``sdf_grad_color_cons``);
  * stratified jitter comes from an explicit ``torch.Generator`` or is
    injected as ``t_rand``.

Quirks kept from the reference (as the JAX package does): the
``inside_sphere`` mask is all ones; background blending of ``render_core``
is disabled; ``n_max_network_queries`` and ``perturb`` are accepted but
unused.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models.fields import (sdf_grad_color, sdf_grad_color_cons,
                             sdf_value_nograd, variance_inv_s)
from ..utils.profiling import span, spanned
from ..utils.tensors import scalar
from .sampling import (_exclusive_transmittance, cat_z_vals, up_sample,
                       up_sample_naive)


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0
    n_max_network_queries: int = 64000
    importance_sampling_start: int = 0
    naive_render: bool = False

    @staticmethod
    def from_cfg(cfg: dict) -> "RendererConfig":
        c = cfg["neus_renderer"]
        return RendererConfig(
            n_samples=c["n_samples"], n_importance=c["n_importance"],
            n_outside=c["n_outside"], up_sample_steps=c["up_sample_steps"],
            perturb=c["perturb"],
            n_max_network_queries=c["n_max_network_queries"],
            importance_sampling_start=c["importance_sampling_start"],
            naive_render=c["naive_render"])


def _with_time(pts: torch.Tensor, time_step) -> torch.Tensor:
    """Append the scalar time step as a 4th coordinate: (..., 3) -> (..., 4)."""
    t = scalar(time_step, pts.dtype, pts.device)
    return torch.cat([pts, t.reshape(1).expand(pts.shape[:-1] + (1,))], -1)


def _last_dist(dists: torch.Tensor, sample_dist) -> torch.Tensor:
    """The (..., 1) closing interval; ``sample_dist`` may be a device scalar
    (no host sync)."""
    d = torch.as_tensor(sample_dist, dtype=dists.dtype, device=dists.device)
    return d.expand(dists.shape[:-1] + (1,))


def render_core_outside(nerf_net, rays_o, rays_d, z_vals, sample_dist,
                        background_rgb=None):
    """Background NeRF++ path. Inactive by default (n_outside == 0)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, _last_dist(dists, sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
    dis = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis, 1.0 / dis], dim=-1)
    dirs = rays_d[:, None, :].expand(pts.shape)
    density, color = nerf_net(pts4, dirs)
    color = torch.sigmoid(color)
    alpha = 1.0 - torch.exp(-F.softplus(density[..., 0]) * dists)
    weights = alpha * _exclusive_transmittance(alpha, eps=1e-6)
    out_color = torch.sum(weights[..., None] * color, dim=1)
    if background_rgb is not None:
        out_color = out_color + background_rgb * (
            1.0 - torch.sum(weights, -1, keepdim=True))
    return {"color": out_color, "sampled_color": color, "alpha": alpha,
            "weights": weights}


@spanned("copenerf.render.core")
def render_core(fields, rays_o, rays_d, rays_d_norm, time_step, z_vals,
                sample_dist, cos_anneal_ratio, *, eval_depth: bool, cons=None):
    """SDF -> alpha (NeuS eq. 13) -> transmittance-weighted compositing of
    color/depth/normals.

    ``cons``: optional ``(cw2 (4, 4), world_time)``, the sdf-consistency
    world transform; the SDF value at the transformed samples comes back as
    ``sdf_world`` (B, S)."""
    batch_size, n_samples = z_vals.shape

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, _last_dist(dists, sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape).contiguous()
    pts_time = _with_time(pts, time_step)                      # (B, S, 4)

    sdf_world = None
    if cons is not None:
        cw2, world_time = cons
        pts_world = pts @ cw2[:3, :3].T + cw2[:3, 3]
        sdf, gradients, sampled_color, sdf_world = sdf_grad_color_cons(
            fields["sdf"], fields["color"], pts_time, dirs,
            _with_time(pts_world, world_time))
    else:
        sdf, gradients, sampled_color = sdf_grad_color(
            fields["sdf"], fields["color"], pts_time, dirs)
    normals = gradients[..., :3]
    sdf_flows = gradients[..., 3:]

    inv_s = torch.clamp(variance_inv_s(fields["variance"]), 1e-3, 1e3)

    true_cos = torch.sum(dirs * normals, dim=-1, keepdim=True)
    # Cos annealing keeps alpha alive early in training.
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + F.relu(-true_cos) * cos_anneal_ratio)

    est_next = sdf + iter_cos * dists[..., None] * 0.5
    est_prev = sdf - iter_cos * dists[..., None] * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp(((prev_cdf - next_cdf + 1e-5) /
                         (prev_cdf + 1e-5))[..., 0], 0.0, 1.0)

    weights = alpha * _exclusive_transmittance(alpha)
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)

    color = torch.sum(sampled_color * weights[..., None], dim=1)
    depth_pred = torch.sum(z_vals * weights, dim=1, keepdim=True)
    weighted_z_vals = depth_pred.detach()
    if eval_depth:
        # Distance along the ray -> z-depth for GT-depth comparison.
        depth_pred = depth_pred / rays_d_norm

    return {
        "color": color,
        "depth_pred": depth_pred,
        "weighted_z_vals": weighted_z_vals,
        "sdf": sdf.reshape(batch_size, n_samples),
        "dists": dists,
        "normals": normals,
        "sdf_flows": sdf_flows,
        "sampled_points": pts,
        "s_val": 1.0 / inv_s,
        "mid_z_vals": mid_z,
        "weights": weights,
        "cdf": prev_cdf[..., 0],
        "weight_sum": weights_sum,
        **({"sdf_world": sdf_world.reshape(batch_size, n_samples)}
           if sdf_world is not None else {}),
    }


@spanned("copenerf.render")
def render(fields, rays_o, rays_d, rays_d_norm, time_step, near, far, *,
           rcfg: RendererConfig, cos_anneal_ratio,
           use_importance: bool = True, train: bool = True,
           generator=None, t_rand=None, background_rgb=None, cons=None):
    """Full render pass (reference ``NeuSRenderer.forward``).

    ``train`` turns stratified jitter on and keeps depth as distance along
    the ray; the jitter comes from ``generator`` unless ``t_rand`` injects it.
    ``cons`` (see ``render_core``) adds ``sdf_world`` to the outputs.
    """
    batch_size = rays_o.shape[0]
    if use_importance:
        n_samples, n_importance = rcfg.n_samples, rcfg.n_importance
    else:
        n_samples, n_importance = rcfg.n_samples + rcfg.n_importance, 0

    with span("copenerf.render.importance"):
        sample_dist = (far[0, 0] - near[0, 0]) / n_samples
        t = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype,
                           device=rays_o.device)
        z_vals = near * (1.0 - t[None, :]) + far * t[None, :]

        if train:
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
            lower = torch.cat([z_vals[..., :1], mids], dim=-1)
            if t_rand is None:
                t_rand = torch.rand((batch_size, n_samples),
                                    generator=generator, device=rays_o.device)
            z_vals = lower + (upper - lower) * t_rand

        if n_importance > 0:
            sdf_net = fields["sdf"]
            # Importance pre-sampling is gradient-free (reference no_grad).
            with torch.no_grad():
                z_vals = z_vals.detach()
                pts = (rays_o[:, None, :]
                       + rays_d[:, None, :] * z_vals[..., None])
                sdf = sdf_value_nograd(
                    sdf_net, _with_time(pts, time_step).contiguous())
                n_per_step = n_importance // rcfg.up_sample_steps
                up_fn = up_sample_naive if rcfg.naive_render else up_sample
                for i in range(rcfg.up_sample_steps):
                    new_z = up_fn(rays_o, rays_d, z_vals, sdf, n_per_step,
                                  64.0 * 2 ** i)
                    if (i + 1) == rcfg.up_sample_steps:
                        z_vals, sdf, _ = cat_z_vals(z_vals, new_z, sdf, None)
                    else:
                        new_pts = (rays_o[:, None, :] +
                                   rays_d[:, None, :] * new_z[..., None])
                        new_sdf = sdf_value_nograd(
                            sdf_net,
                            _with_time(new_pts, time_step).contiguous())
                        z_vals, sdf, _ = cat_z_vals(z_vals, new_z, sdf,
                                                    new_sdf)
            n_samples = n_samples + n_importance

    if rcfg.n_outside > 0:
        z_out = torch.linspace(1e-3, 1.0 - 1.0 / (rcfg.n_outside + 1.0),
                               rcfg.n_outside, device=rays_o.device)
        z_out = far / torch.flip(z_out, (-1,)) + 1.0 / rcfg.n_samples
        z_feed, _ = torch.sort(torch.cat([z_vals, z_out], dim=-1), dim=-1)
        # Blending is disabled upstream; the pass runs for parity only.
        render_core_outside(fields["nerf"], rays_o, rays_d, z_feed,
                            sample_dist, background_rgb)

    ret = render_core(fields, rays_o, rays_d, rays_d_norm, time_step, z_vals,
                      sample_dist, cos_anneal_ratio, eval_depth=not train,
                      cons=cons)

    weights = ret["weights"]
    if background_rgb is not None:
        ret["color"] = ret["color"] + background_rgb * (1.0 - ret["weight_sum"])
    return {
        "sdf": ret["sdf"],
        "color_fine": ret["color"],
        "depth_pred": ret["depth_pred"],
        "weighted_z_vals": ret["weighted_z_vals"],
        "s_val": ret["s_val"].expand(batch_size, 1),
        "cdf_fine": ret["cdf"],
        "weight_sum": ret["weight_sum"],
        "weight_max": torch.amax(weights, dim=-1, keepdim=True),
        "normals": ret["normals"],
        "sdf_flows": ret["sdf_flows"],
        "sampled_points": ret["sampled_points"],
        "weights": weights,
        "mid_z_vals": ret["mid_z_vals"],
        **({"sdf_world": ret["sdf_world"]} if "sdf_world" in ret else {}),
    }
