"""Render traffic: ``ImageRenderer.render_image`` of whole views at the
configuration's resolution, at seeded poses and times, one after another."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scene, work
from portbench.drivers._common import (iter_seed, program_cfg, program_fields,
                                       tf32)
from portbench.reference import render as ref_render


class Driver:
    kind = "render"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from copenerf_torch.evaluation.render import ImageRenderer
        from copenerf_torch.ops.renderer import RendererConfig

        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(iter_seed(seed, 2 ** 19))
        self.weights0 = scene.make_weights(cfg, gen, dev)
        self.fields = program_fields(cfg, self.weights0, dev)
        self.renderer = ImageRenderer(RendererConfig.from_cfg(program_cfg(cfg)),
                                      chunk=int(mix["chunk"]), device=dev)
        self.h, self.w = (int(v) for v in cfg["training"]["resolution"])
        self.rays_per_unit = self.h * self.w
        self.k = scene.camera_mat(cfg)
        self.gen = torch.Generator(device=dev)
        self.views = []         # (pose, time, sampled idx, outputs)
        self.failed = 0

    def _view(self, v: int):
        """The seeded pose and time of view ``v`` and its sampled pixels."""
        self.gen.manual_seed(iter_seed(self.seed, v))
        m = self.mix["pose"]
        pose = scene.near_identity_poses(self.gen, 1, float(m["rotation"]),
                                         float(m["translation"]),
                                         self.device)[0]
        t = float(torch.rand((), generator=self.gen, device=self.device)) * 2 - 1
        idx = torch.randint(0, self.rays_per_unit,
                            (int(self.mix["check_rays_per_view"]),),
                            generator=self.gen, device=self.device)
        return pose, t, idx

    def _render(self, pose, t, resolution):
        d = self.cfg["rendering"]["depth_range"]
        return self.renderer.render_image(
            self.fields, self.k, pose.cpu().numpy(), np.eye(4, dtype=np.float32),
            t, resolution, d, float(self.mix["cos_anneal_ratio"]))

    def warm_up(self):
        pose, t, _ = self._view(2 ** 18)
        self._render(pose, t, self.mix["warmup_resolution"])

    def unit(self):
        pose, t, idx = self._view(len(self.views))
        res = self._render(pose, t, (self.h, self.w))
        i = idx.cpu().numpy()
        out = {k: res[k].reshape(self.rays_per_unit, -1)[i]
               for k in ("color", "depth", "normal")}
        if not all(np.isfinite(v).all() for v in out.values()):
            self.failed += 1
        self.views.append((pose, t, idx, out))

    def counts(self):
        return len(self.views), self.failed

    def unit_flop(self) -> float:
        """The model's operations in one view (``work.render_flop``)."""
        return work.render_flop(self.cfg, self.rays_per_unit)

    def release(self):
        del self.fields, self.renderer

    @property
    def readings(self):
        return [out for *_, out in self.views]

    def reference(self, precision="f32"):
        w = self.weights0
        d = self.cfg["rendering"]["depth_range"]
        k = torch.from_numpy(self.k).to(self.device)
        eye = torch.eye(4, device=self.device)
        outs = []
        for pose, t, idx, _ in self.views:
            parts = {"color": [], "depth": [], "normal": []}
            for blk in torch.split(idx, 4096):
                _, p_norm = ref_render.pixels(blk, self.h, self.w)
                ro, rd, rn = ref_render.rays(p_norm, k, pose, eye)
                with tf32(precision, self.device), torch.no_grad():
                    r = ref_render.render(
                        w, self.cfg, ro, rd, rn, t, float(d[0]), float(d[1]),
                        cos_anneal_ratio=float(self.mix["cos_anneal_ratio"]),
                        precision=precision)
                normal = torch.sum(r["normals"] * r["weights"][..., None], 1)
                parts["color"].append(r["color"].detach())
                parts["depth"].append(r["depth"].detach())
                parts["normal"].append((normal @ pose[:3, :3].T).detach())
            outs.append({key: torch.cat(v).cpu().numpy()
                         for key, v in parts.items()})
        return outs

    def compare(self, prog, ref) -> dict:
        """The widest gap over the sampled rays of every view: color (of
        1), depth (over the depth range) and the composited normal."""
        d = self.cfg["rendering"]["depth_range"]
        span = float(d[1]) - float(d[0])

        def widest(key, scale=1.0):
            return max(float(np.max(np.abs(p[key] - r[key]))) / scale
                       for p, r in zip(prog, ref))

        if len(prog) != len(ref) or not prog:
            return {"color_gap": math.inf, "depth_gap": math.inf,
                    "normal_gap": math.inf}
        return {"color_gap": widest("color"), "depth_gap": widest("depth", span),
                "normal_gap": widest("normal")}
