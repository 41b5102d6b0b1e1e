"""Chunked full-image rendering (port of ``copenerf_tpu/evaluation/render.py``).

The serving path: visualization, stage-1 depth extraction and the NVS/depth
evaluation all render through ``ImageRenderer.render_image``. Pixel
coordinates are generated on the device from ``(start, h, w)``; the padded
tail of the last chunk clamps to the last pixel and is cut off on the host.

With a process group the render is split over the ranks, as the JAX
package shards each chunk's rays over its mesh: every rank renders its
contiguous 1/world slice of each chunk and ``gather_rays`` rebuilds the
chunk, so every rank returns the whole view. A ray's outputs depend on no
other ray, so the split render is the single-device one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.rays import rays_from_pixels
from ..ops.renderer import RendererConfig, render
from ..parallel.distributed import rank, world_size
from ..parallel.mesh import gather_rays
from ..utils.profiling import span, spanned

# The per-ray outputs of a chunk, with their widths (the gathered layout).
KEYS = (("color", 3), ("depth", 1), ("weighted_z", 1), ("normal", 3),
        ("depth_highest", 1))


class ImageRenderer:
    """Chunked renderer for one renderer config on one device.

    ``chunk`` is the MAX rays per chunk (default 32768). Per image the
    effective chunk is the next power of two >= the pixel count (at least
    ``min(1024, chunk)``), capped at ``chunk`` rounded down to a power-of-two
    multiple of that minimum.

    ``group`` (a process group; None renders on this device alone) splits
    each chunk over the ranks: the minimum is then rounded down to a
    multiple of the world size, never up (the cap is a memory maximum), and
    a ``chunk`` below the world size raises. Every rank must call
    ``render_image`` with the same arguments.
    """

    def __init__(self, rcfg: RendererConfig, chunk: int = 32768,
                 device="cuda", group=None):
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.group = group
        self.world = world_size(group) if group is not None else 1
        self.rank = rank(group) if group is not None else 0
        if chunk < self.world:
            raise ValueError(
                f"render chunk {chunk} < mesh size {self.world}; the chunk "
                "cap is an HBM maximum and cannot be rounded up to a mesh "
                "multiple — raise training.render_chunk or shrink the mesh")
        self.min_chunk = min(max(1024, self.world), max(chunk, 1))
        self.min_chunk -= self.min_chunk % self.world
        self.chunk = self.min_chunk
        while self.chunk * 2 <= chunk:
            self.chunk *= 2

    @spanned("copenerf.view.chunk")
    def _chunk(self, fields, chunk, start, h, w, camera_mat, world_mat,
               scale_mat, time_step, near, far, cos_anneal_ratio):
        dev = self.device
        idx = torch.clamp(start + torch.arange(chunk, device=dev),
                          max=h * w - 1)
        row = torch.div(idx, w, rounding_mode="floor").float()
        col = (idx % w).float()
        pixels = torch.stack([2.0 * col / (w - 1.0) - 1.0,
                              2.0 * row / (h - 1.0) - 1.0], dim=-1)
        rays_o, rays_d, rays_d_norm = rays_from_pixels(
            pixels, camera_mat, world_mat, scale_mat)
        n = rays_o.shape[0]
        near_v = torch.full((n, 1), float(near), device=dev)
        far_v = torch.full((n, 1), float(far), device=dev)
        out = render(fields, rays_o, rays_d, rays_d_norm, time_step, near_v,
                     far_v, rcfg=self.rcfg,
                     cos_anneal_ratio=cos_anneal_ratio,
                     use_importance=True, train=False)
        weights = out["weights"]                           # (N, S)
        normals = out["normals"]                           # (N, S, 3)
        normal_w = torch.sum(normals * weights[..., None], dim=1)
        # Rotate into the anchor frame (world_mat == I is a no-op).
        normal_w = normal_w @ world_mat[:3, :3].T
        pts = out["sampled_points"]                        # (N, S, 3)
        pts_t = pts @ world_mat[:3, :3].T + world_mat[:3, 3]
        max_idx = torch.argmax(weights, dim=1)
        pts_max = torch.gather(
            pts_t, 1, max_idx[:, None, None].expand(n, 1, 3))[:, 0]
        return {
            "color": out["color_fine"],
            "depth": out["depth_pred"][:, 0],
            "weighted_z": out["weighted_z_vals"][:, 0],
            "normal": normal_w,
            "depth_highest": -pts_max[:, 2],
            "weights": weights,
            "pts": pts,
        }

    @spanned("copenerf.view")
    @torch.no_grad()
    def render_image(self, fields, camera_mat, world_mat, scale_mat,
                     time_step, resolution, depth_range, cos_anneal_ratio,
                     want_pts: bool = False):
        """Render a full (h, w) view. Returns a dict of numpy arrays:
        color (h, w, 3), depth (h, w), weighted_z (h, w), normal (h, w, 3),
        depth_highest (h, w) [, weights_flat/pts_flat when ``want_pts``]."""
        param_dev = next(fields.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"fields live on {param_dev}, renderer on "
                             f"{self.device}")
        h, w = int(resolution[0]), int(resolution[1])
        n = h * w
        chunk = self.min_chunk
        while chunk < n and chunk < self.chunk:
            chunk *= 2
        n_total = n + ((-n) % chunk)

        def mat(m):
            return torch.as_tensor(np.asarray(m, np.float32),
                                   device=self.device)

        camera_mat, world_mat, scale_mat = (mat(camera_mat), mat(world_mat),
                                            mat(scale_mat))
        time_step = torch.tensor(float(time_step), device=self.device)
        keys = [k for k, _ in KEYS]
        outs = {k: [] for k in keys}
        extra = {"weights": [], "pts": []}
        # This rank's slice of every chunk.
        part = chunk // self.world
        # Results stay on the device until the end: a host fetch per chunk
        # would serialize against the next chunk's launches.
        for i in range(0, n_total, chunk):
            res = self._chunk(fields, part, i + self.rank * part, h, w,
                              camera_mat, world_mat, scale_mat, time_step,
                              depth_range[0], depth_range[1],
                              float(cos_anneal_ratio))
            if self.group is not None:
                res = self._gather(res, want_pts)
            for k in keys:
                outs[k].append(res[k])
            if want_pts:
                extra["weights"].append(res["weights"])
                extra["pts"].append(res["pts"])

        result = {}
        with span("copenerf.view.fetch"):
            for k, chunks in outs.items():
                arr = torch.cat(chunks, 0)[:n].cpu().numpy()
                result[k] = (arr.reshape(h, w, -1) if k in ("color", "normal")
                             else arr.reshape(h, w))
            if want_pts:
                result["weights_flat"] = torch.cat(
                    extra["weights"], 0)[:n].cpu().numpy()
                result["pts_flat"] = torch.cat(extra["pts"], 0)[:n].cpu().numpy()
        return result

    def _gather(self, res: dict, want_pts: bool) -> dict:
        """Every rank's slice of a chunk's outputs, in rank order: one
        all-gather of the outputs packed side by side."""
        cols = [res[k].reshape(res[k].shape[0], -1) for k, _ in KEYS]
        widths = [width for _, width in KEYS]
        if want_pts:
            cols += [res["weights"], res["pts"].reshape(len(res["pts"]), -1)]
            widths += [res["weights"].shape[1], res["pts"][0].numel()]
        full = gather_rays(torch.cat(cols, 1), self.group)
        out = dict(zip([k for k, _ in KEYS] + ["weights", "pts"],
                       torch.split(full, widths, 1)))
        for k in ("depth", "weighted_z", "depth_highest"):
            out[k] = out[k][:, 0]
        if want_pts:
            out["pts"] = out["pts"].reshape(len(full), *res["pts"].shape[1:])
        return out
