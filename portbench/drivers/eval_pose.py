"""Eval-pose traffic: ``evaluator.pose_loss``, its backward and one Adam
over every test view's ``r``, ``t`` under ``frozen(fields)``, epochs over
the test views as ``Evaluator.eval_optimization`` runs them."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scene, work
from portbench.drivers._common import (FIRST, compare_steps, iter_seed, norm,
                                       program_cfg, program_fields,
                                       step_readings, tf32)
from portbench.reference import render as ref_render
from portbench.reference import train as ref_train


def _exp_so3(r):
    """Rodrigues' formula, with its Taylor expansion below |r| = 1e-3 (the
    gradient at r = 0, where every test pose starts)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    skew = torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)
    sq = torch.sum(r * r, -1)[..., None, None]
    small = sq < 1e-6
    safe = torch.where(small, torch.ones_like(sq), sq)
    n = torch.sqrt(safe)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(n) / n)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(n)) / safe)
    return torch.eye(3, device=r.device) + a * skew + b * (skew @ skew)


def _c2w(r, t):
    top = torch.cat([_exp_so3(r), t[..., None]], -1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                                        device=r.device)], -2)


class Driver:
    kind = "eval_pose"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from copenerf_torch.evaluation.evaluator import frozen
        from copenerf_torch.ops.renderer import RendererConfig
        from copenerf_torch.poses.retriever import pose_retriever_init
        from copenerf_torch.training.schedules import MultiStepLR

        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(iter_seed(seed, 2 ** 19))
        self.weights0 = scene.make_weights(cfg, gen, dev)
        self.h, self.w = (int(v) for v in cfg["training"]["resolution"])
        n = int(cfg["assumed"]["n_frames"])
        _, i_test = scene.split(cfg)
        frames = scene.make_frames(gen, n, self.h, self.w, dev)
        self.images = frames[i_test].float() / 255.0
        del frames
        self.n_test = len(i_test)
        m = mix["init_pose"]
        self.init_c2w = scene.near_identity_poses(
            gen, self.n_test, float(m["rotation"]), float(m["translation"]), dev)
        self.k = torch.from_numpy(scene.camera_mat(cfg)).to(dev)
        self.world_time = torch.tensor(
            scene.frame_time(scene.world_cam(cfg), n), device=dev)
        self.rays_per_unit = int(mix["rays"])
        d = cfg["rendering"]["depth_range"]
        ones = torch.ones((self.rays_per_unit, 1), device=dev)
        self.near, self.far = ones * float(d[0]), ones * float(d[1])
        self.fields = program_fields(cfg, self.weights0, dev)
        self.rcfg = RendererConfig.from_cfg(program_cfg(cfg))
        pose, _ = pose_retriever_init(self.n_test, self.init_c2w, device=dev)
        self.r = pose["r"].requires_grad_(True)
        self.t = pose["t"].requires_grad_(True)
        self.opt = torch.optim.Adam([self.r, self.t], lr=0.0,
                                    betas=(0.9, 0.999), eps=1e-8)
        ev = cfg["eval"]
        epochs = int(ev["eval_pose_epoch"])
        self.sched = MultiStepLR(float(ev["eval_pose_lr"]),
                                 range(0, epochs, max(epochs // 5, 1)),
                                 float(ev["eval_pose_scheduler_gamma"]))
        self.frozen = frozen(self.fields)
        self.frozen.__enter__()
        self.gen = torch.Generator(device=dev)
        self.it = 0
        self.l2s, self.losses = [], []
        self.readings = None

    def unit(self):
        from copenerf_torch.evaluation.evaluator import pose_loss
        from copenerf_torch.training.step import sample_patch_indices

        view, epoch = self.it % self.n_test, self.it // self.n_test
        if view == 0:
            for group in self.opt.param_groups:
                group["lr"] = self.sched.epoch_lr(epoch)
        self.it += 1
        self.gen.manual_seed(iter_seed(self.seed, self.it))
        ray_idx = sample_patch_indices(self.gen, self.h, self.w, 1,
                                       self.rays_per_unit, device=self.device)
        loss, l2 = pose_loss(
            self.fields, self.rcfg, self.r[view], self.t[view],
            self.init_c2w[view], self.images[view], self.k, ray_idx,
            self.world_time, self.near, self.far, generator=self.gen)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.l2s.append(l2)
        self.losses.append(loss.detach())
        if view == self.n_test - 1 and epoch % 10 == 0:
            # One host copy every 10 epochs, as the evaluation logs.
            float(torch.stack(self.l2s[-self.n_test:]).mean())

    def warm_up(self):
        import copenerf_torch.evaluation.evaluator as evaluator

        start = (self.r.detach().clone(), self.t.detach().clone())
        colors = []
        program_render = evaluator.render

        def seen(*args, **kw):
            # The rays' colors as the pose step's render returns them.
            out = program_render(*args, **kw)
            colors.append(out["color_fine"].detach().clone())
            return out

        evaluator.render = seen
        try:
            self.unit()
            st = self.opt.state
            grads = {k: norm(st[p]["exp_avg"] / 0.1) if "exp_avg" in st[p]
                     else 0.0 for k, p in (("r", self.r), ("t", self.t))}
            for _ in range(FIRST - 1):
                self.unit()
        finally:
            evaluator.render = program_render
        steps = {"r": norm(self.r.detach() - start[0]),
                 "t": norm(self.t.detach() - start[1])}
        self.readings = step_readings(
            [float(x) for x in torch.stack(self.losses[:FIRST]).cpu()],
            grads, steps)
        self.readings["colors"] = [c.cpu().numpy() for c in colors]
        for _ in range(int(self.mix["warmup_units"])):
            self.unit()
        self.first = len(self.l2s)

    def counts(self):
        """(units run in the window, units whose l2 is not finite)."""
        l2 = torch.stack(self.l2s[self.first:]).cpu()
        return len(l2), int((~torch.isfinite(l2)).sum())

    def unit_flop(self) -> float:
        """The model's operations in one pose step, with no weight gradient
        (``work.pose_step_flop``)."""
        return work.pose_step_flop(self.cfg, self.rays_per_unit)

    def release(self):
        self.frozen.__exit__(None, None, None)
        del self.fields, self.opt

    def _lr(self, epoch: int) -> float:
        ev = self.cfg["eval"]
        e = int(ev["eval_pose_epoch"])
        passed = sum(1 for m in range(0, e, max(e // 5, 1)) if m <= epoch)
        return float(ev["eval_pose_lr"]) * float(
            ev["eval_pose_scheduler_gamma"]) ** passed

    def reference(self, precision="f32") -> dict:
        w = self.weights0
        d = self.cfg["rendering"]["depth_range"]
        r = torch.zeros((self.n_test, 3), device=self.device, requires_grad=True)
        t = torch.zeros((self.n_test, 3), device=self.device, requires_grad=True)
        opt = ref_train.Adam({"r": r, "t": t})
        eye = torch.eye(4, device=self.device)
        losses, grads0, colors = [], None, []
        for it in range(1, FIRST + 1):
            view, epoch = (it - 1) % self.n_test, (it - 1) // self.n_test
            self.gen.manual_seed(iter_seed(self.seed, it))
            idx = ref_train.sample_patches(self.gen, self.h, self.w, 1,
                                           self.rays_per_unit, self.device)
            t_rand = torch.rand(
                (self.rays_per_unit, self.cfg["neus_renderer"]["n_samples"]),
                generator=self.gen, device=self.device)
            _, p_norm = ref_render.pixels(idx, self.h, self.w)
            gt = self.images[view].reshape(3, -1)[:, idx].T
            with tf32(precision, self.device):
                world = _c2w(r[view], t[view]) @ self.init_c2w[view]
                ro, rd, rn = ref_render.rays(p_norm, self.k, world, eye)
                out = ref_render.render(
                    w, self.cfg, ro, rd, rn, self.world_time, float(d[0]),
                    float(d[1]), cos_anneal_ratio=1.0, t_rand=t_rand,
                    precision=precision)
                loss = torch.sum(torch.abs(out["color"] - gt)) / len(idx)
                gr, gt_ = torch.autograd.grad(loss, [r, t])
            losses.append(float(loss.detach()))
            colors.append(out["color"].detach().cpu().numpy())
            if grads0 is None:
                grads0 = {"r": norm(gr), "t": norm(gt_)}
            opt.step({"r": gr, "t": gt_}, self._lr(epoch))
        steps = {"r": norm(r.detach()), "t": norm(t.detach())}
        out = step_readings(losses, grads0, steps)
        out["colors"] = colors
        return out

    @staticmethod
    def compare(prog, ref) -> dict:
        """``compare_steps``' numbers and two of the rays' color gaps (each
        ray's widest channel) over the first steps' rays: the widest ray's
        and the median ray's. The pose step's loss and gradient average
        over a thousand rays and so hide an error that each ray's color
        shows. The widest swings with the seed: a ray that grazes a surface
        moves its color far under any rounding of its inputs, the
        reference's own; the median ray's gap is steady from seed to seed
        and parts the program from the TF32 control."""
        gaps = compare_steps(prog, ref)
        pc, rc = prog["colors"], ref["colors"]
        if len(pc) == len(rc) and all(a.shape == b.shape
                                      for a, b in zip(pc, rc)):
            ray = np.concatenate([np.abs(a - b).max(-1)
                                  for a, b in zip(pc, rc)])
            gaps["color_gap"] = float(ray.max())
            gaps["color_p50_gap"] = float(np.median(ray))
        else:
            gaps["color_gap"] = gaps["color_p50_gap"] = math.inf
        return gaps
