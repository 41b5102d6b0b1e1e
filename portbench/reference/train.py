"""CoPE-NeRF's training step in plain PyTorch: patch sampling, the losses
of stage 1 and stage 2, the motion chain and two Adam updates.

Stage 1 queries each frame's own camera space at its time; its losses are
the photometric L1, the eikonal term, the sdf-flow term (the scene flow of
the motion net against the SDF's time derivative, weighted by the detached
render weights), the flow-rgb term (the render's expected point warped into
each reference frame through the integrated motion chain), the
sdf-consistency term (the SDF at the samples moved into the world camera's
frame at its time) and, with patches, the depth smoothness terms. Stage 2
queries the canonical space through each view's fixed pose, with the
photometric and eikonal terms alone. The field optimizer covers the SDF,
color and variance; the motion optimizer the motion net.
"""

from __future__ import annotations

import math

import torch

from . import nets
from .render import pixels, rays, render


def sample_patches(gen, h: int, w: int, ps: int, n: int, device):
    """Flat ray indices of n / ps^2 whole patches whose corners are the
    top-k of uniform draws over every possible corner."""
    h_adj, w_adj = h - ps + 1, w - ps + 1
    z = torch.rand(h_adj * w_adj, generator=gen, device=device)
    corners = torch.topk(z, n // (ps * ps), sorted=False).indices
    start = (corners // w_adj) * w + corners % w_adj
    off = torch.arange(ps, device=device)
    offsets = (off[None, :] + off[:, None] * w).reshape(-1)
    return (start[:, None] + offsets[None, :]).reshape(-1)


def _axis(axis, a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    flat = {"X": (one, zero, zero, zero, c, -s, zero, s, c),
            "Y": (c, zero, s, zero, one, zero, -s, zero, c),
            "Z": (c, -s, zero, s, c, zero, zero, zero, one)}[axis]
    return torch.stack(flat, -1).reshape(a.shape + (3, 3))


def euler_xyz(e):
    return _axis("X", e[..., 0]) @ _axis("Y", e[..., 1]) @ _axis("Z", e[..., 2])


def se3_inv(m):
    rt = m[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rt, -rt @ m[..., :3, 3:]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=m.device).expand(
        top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def motion_chain(layers, mcfg, n_images: int, substeps: int, precision):
    """World (frame 0) -> camera maps of every frame: the motion net's
    angular and linear velocities integrated by Euler substeps between
    consecutive frame times t_i = i / (N - 1) * 2 - 1, chained."""
    dev = layers[0][0].device
    n_int = n_images - 1
    dt = 2.0 / (n_int * substeps)
    t0 = torch.arange(n_int, dtype=torch.float32, device=dev) / n_int * 2 - 1
    times = t0[:, None] + dt * torch.arange(substeps, dtype=torch.float32,
                                            device=dev)[None]
    omega, vel = nets.motion_forward(layers, mcfg, times.reshape(-1, 1),
                                     precision)
    r_steps = euler_xyz(omega.reshape(n_int, substeps, 3) * dt)
    v_steps = vel.reshape(n_int, substeps, 3) * dt
    rot = torch.eye(3, device=dev).expand(n_int, 3, 3)
    trans = torch.zeros((n_int, 3), device=dev)
    for k in range(substeps):
        trans = (r_steps[:, k] @ trans[..., None])[..., 0] + v_steps[:, k]
        rot = rot @ r_steps[:, k]
    rel = torch.cat([torch.cat([rot, trans[..., None]], -1),
                     torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(
                         n_int, 1, 4)], -2)
    out = [torch.eye(4, device=dev)]
    for k in range(n_int):
        out.append(rel[k] @ out[-1])
    return torch.stack(out)


def bilinear(image, uv):
    """(C, H, W) sampled at pixel coordinates uv (N, 2), clamped to the
    border; the lower corner clamped to W-2, H-2. Returns (N, C)."""
    _, h, w = image.shape
    x = torch.minimum(torch.maximum(uv[:, 0], uv.new_zeros(())),
                      uv.new_full((), w - 1.0))
    y = torch.minimum(torch.maximum(uv[:, 1], uv.new_zeros(())),
                      uv.new_full((), h - 1.0))
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    flat = image.reshape(image.shape[0], h * w)

    def at(yy, xx):
        return flat[:, yy * w + xx].T

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _image(stack, idx):
    img = stack[idx]
    return img.float() / 255.0 if img.dtype == torch.uint8 else img


def _smooth_terms(depth, rgb, ps, gamma=0.1):
    """(edge-aware smoothness, smoothness) of (P, ps, ps, 1) depth patches."""
    def diffs(t):
        return (t[:, :, :-1] - t[:, :, 1:], t[:, :-1, :] - t[:, 1:, :],
                t[:, :-1, :-1] - t[:, 1:, 1:], t[:, 1:, :-1] - t[:, :-1, 1:])

    dd, dc = diffs(depth), diffs(rgb)
    edge = sum(torch.mean(torch.abs(torch.exp(
        -torch.sum(torch.abs(c), -1) / gamma)[..., None] * d))
        for d, c in zip(dd, dc)) / 4.0
    plain = sum(torch.mean(torch.abs(d)) for d in dd) / 4.0
    return edge, plain


def loss(w, cfg: dict, s: dict, batch: dict, ray_idx, t_rand,
         precision="f32"):
    """The step's total loss. ``s`` holds h, w, patch_size, stage1, n_images,
    n_ref, sdf_cons_pose_grad, use_flow_rgb, use_sdf_consistency,
    smooth_scale."""
    dev = ray_idx.device
    h, wd = s["h"], s["w"]
    p, p_norm = pixels(ray_idx, h, wd)
    idx = batch["image_idx"]
    rgb_gt = _image(batch["images_all"], idx).reshape(3, h * wd)[:, ray_idx].T
    ro, rd, rn = rays(p_norm, batch["K_all"][idx], batch["world_mat"],
                      batch["scale_mat"])
    cons = w2c = inv_here = None
    if s["stage1"] and (s["use_flow_rgb"] or s["use_sdf_consistency"]):
        w2c = motion_chain(w["motion"], cfg["motion_network"], s["n_images"],
                           cfg["training"]["nb_sample_timestep"], precision)
        inv_here = se3_inv(w2c[idx])
        if s["use_sdf_consistency"]:
            cw2 = w2c[batch["world_cam_idx"]] @ inv_here
            if not s["sdf_cons_pose_grad"]:
                cw2 = cw2.detach()
            cons = (cw2, batch["world_time_step"])
    out = render(w, cfg, ro, rd, rn, batch["query_time_step"],
                 float(batch["near"]), float(batch["far"]),
                 cos_anneal_ratio=batch["cos_anneal_ratio"], t_rand=t_rand,
                 cons=cons, precision=precision)
    lw = batch["loss_weights"]
    n = ro.shape[0]
    total = lw["rgb"] * torch.sum(torch.abs(out["color"] - rgb_gt)) / n
    total = total + lw["eikonal"] * torch.mean(
        (torch.linalg.norm(out["normals"].reshape(-1, 3), dim=-1) - 1) ** 2)
    if s["stage1"]:
        pts = out["points"].reshape(-1, 3)
        t_q = torch.as_tensor(batch["query_time_step"], dtype=torch.float32,
                              device=dev).reshape(1, 1)
        omega, vel = nets.motion_forward(w["motion"], cfg["motion_network"],
                                         t_q, precision)
        flow = torch.cross(omega[0].expand(pts.shape), pts, dim=-1) + vel[0]
        wts = out["weights"].reshape(-1).detach()
        lhs = torch.sum(flow * out["normals"].reshape(-1, 3), -1)
        total = total + lw["sdf"] * torch.sum(
            torch.abs(lhs + out["sdf_flows"].reshape(-1)) * wts) / (
                torch.sum(wts) + 1e-10)
        any_ref = torch.max(batch["ref_in_list"]) > 0
        if s["use_sdf_consistency"]:
            active = any_ref & (torch.as_tensor(idx, device=dev)
                                != torch.as_tensor(batch["world_cam_idx"],
                                                   device=dev))
            term = torch.mean(torch.abs(out["sdf_world"].reshape(-1)
                                        - out["sdf"].reshape(-1)))
            total = total + lw["sdf_consistency"] * torch.where(
                active, term, torch.zeros((), device=dev))
        if s["use_flow_rgb"]:
            size = torch.tensor([float(wd), float(h)], device=dev)
            wpm_w = out["weights"][..., None]
            terms = []
            for t in range(s["n_ref"]):
                ref = torch.clamp(batch["ref_idxs"][t], 0, s["n_images"] - 1)
                m = w2c[ref] @ inv_here
                wpm = torch.sum(wpm_w * (out["points"] @ m[:3, :3].T
                                         + m[:3, 3]), dim=1)
                proj = batch["scale_mat"][:3, :3] @ batch["K_all"][ref][:3, :3]
                pix = wpm @ proj.T
                z = pix[:, 2:]
                z = torch.where(torch.abs(z) < 1e-8,
                                torch.where(z < 0, -1e-8, 1e-8), z)
                corr = p + (pix[:, :2] / z - p_norm) * (size / 2.0)
                inside = (corr >= 0).all(1) & (corr < size).all(1)
                valid = (inside.float()
                         * batch["ref_valid_flow"][t]).detach()[:, None]
                warped = bilinear(_image(batch["images_all"], ref), corr)
                terms.append(torch.sum(torch.abs(warped - rgb_gt) * valid)
                             / (torch.sum(valid) + 1e-10))
            total = total + lw["flow_rgb"] * torch.where(
                any_ref, torch.sum(torch.stack(terms)) / 3.0,
                torch.zeros((), device=dev))
    ps = s["patch_size"]
    if ps > 1:
        depth = out["depth"].reshape(n // ps ** 2, ps, ps, 1)
        rgb = rgb_gt.reshape(n // ps ** 2, ps, ps, 3)
        edge, plain = _smooth_terms(depth, rgb, ps)
        scale = 1.0 / 2 ** s["smooth_scale"]
        total = total + lw["edge_smooth"] * scale * edge \
            + lw["smooth"] * scale * plain
    return total


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over named leaves."""

    def __init__(self, leaves: dict):
        self.leaves = leaves
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        self.count += 1
        c1 = 1 - 0.9 ** self.count
        c2 = 1 - 0.999 ** self.count
        for k, p in self.leaves.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
