"""Train traffic: the train step of ``copenerf_torch.training.step`` as the
``Trainer`` builds and feeds it (device tables, a seeded view order a pass,
the generator reseeded every iteration), back to back."""

from __future__ import annotations

import numpy as np
import torch

from portbench import scene, work
from portbench.drivers._common import (FIRST, clone, compare_steps, iter_seed,
                                       norm, program_cfg, program_fields,
                                       step_readings, tf32)
from portbench.reference import train as ref_train


class Driver:
    kind = "train"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from copenerf_torch.ops.renderer import RendererConfig
        from copenerf_torch.training.step import (StepStatic, build_train_step,
                                                  init_train_state)

        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = dev = torch.device(device)
        tr = cfg["training"]
        gen = torch.Generator(device=dev).manual_seed(iter_seed(seed, 2 ** 19))
        self.weights0 = scene.make_weights(cfg, gen, dev)
        self.h, self.w = (int(v) for v in tr["resolution"])
        n = int(cfg["assumed"]["n_frames"])
        self.n_frames = n
        self.frames = scene.make_frames(gen, n, self.h, self.w, dev)
        self.i_train, _ = scene.split(cfg)
        self.stage1 = int(mix["stage"]) == 1
        self.rays_per_unit = int(mix["rays"])
        self.static = dict(
            h=self.h, w=self.w, patch_size=int(mix["patch_size"]),
            n_points=self.rays_per_unit, stage1=self.stage1, n_images=n,
            nb_sample_timestep=int(tr["nb_sample_timestep"]),
            n_ref=len(cfg["dataloading"]["random_ref_interval"]),
            train_motion=bool(mix["train_motion"]),
            sdf_cons_pose_grad=bool(tr["sdf_consistency_enable_pose_grad"]),
            use_flow_rgb=sum(tr["flow_rgb_weight"]) != 0,
            use_sdf_consistency=sum(tr["sdf_consistency_weight"]) != 0,
            smooth_scale=1)
        k = torch.from_numpy(scene.camera_mat(cfg)).to(dev)
        self.tables = self._tables(gen, k)
        fields = program_fields(cfg, self.weights0, dev)
        self.rcfg = RendererConfig.from_cfg(program_cfg(cfg))
        self.state = init_train_state(fields)
        self.step = build_train_step(self.rcfg, StepStatic(**self.static))
        self.gen = torch.Generator(device=dev)
        self.it = int(mix["iteration"])
        self.order = np.random.RandomState(self.seed % 2 ** 32)
        self.queue = []
        self.done = []          # (pos, it) of every step run
        self.losses = []
        self.readings = None

    def _tables(self, gen, k):
        dev = self.device
        idxs, in_list, valid = scene.ref_tables(self.cfg)
        n = self.n_frames
        wci = scene.world_cam(self.cfg)
        t = {"K_all": k.expand(n, 4, 4).contiguous(),
             "ref_idxs": torch.from_numpy(idxs).to(dev),
             "ref_in_list": torch.from_numpy(in_list).to(dev),
             "ref_valid_flow": torch.from_numpy(valid).to(dev),
             "image_idx": torch.tensor(self.i_train, device=dev),
             "time": torch.tensor([scene.frame_time(i, n) for i in self.i_train],
                                  dtype=torch.float32, device=dev),
             "world_cam_idx": torch.tensor(wci, device=dev),
             "world_time": torch.tensor(scene.frame_time(wci, n),
                                        dtype=torch.float32, device=dev),
             "eye": torch.eye(4, device=dev)}
        if not self.stage1:
            m = self.mix["refined_pose"]
            poses = scene.near_identity_poses(gen, len(self.i_train),
                                              float(m["rotation"]),
                                              float(m["translation"]), dev)
            poses[self.i_train.index(wci)] = torch.eye(4, device=dev)
            t["world_mat"] = poses
        return t

    def batch(self, pos: int, it: int) -> dict:
        """The batch of train view ``pos`` at iteration ``it``, laid out as
        the ``Trainer`` lays it out."""
        from copenerf_torch.training.schedules import (cos_anneal_ratio,
                                                       scalar_annealing)
        from copenerf_torch.training.step import make_loss_weights

        tr, t, s1 = self.cfg["training"], self.tables, self.stage1
        stage = 0 if s1 else 1
        cons_w = tr["sdf_consistency_weight"]
        if tr["end_consistency_weight_increase_iteration"] != -1:
            cons = scalar_annealing(
                it, 0.0, tr["end_consistency_weight_increase_iteration"],
                cons_w[0], cons_w[1])
        else:
            cons = cons_w[stage]
        smooth = int(self.mix["patch_size"]) > 1
        weights = make_loss_weights(
            tr["rgb_weight"][stage], tr["eikonal_weight"][stage],
            tr["sdf_weight"][stage], tr["flow_rgb_weight"][stage], cons,
            tr["edge_aware_smoothness_weight"][0 if smooth else 1],
            tr["smoothness_weight"][0 if smooth else 1])
        return {
            "images_all": self.frames, "K_all": t["K_all"],
            "ref_idxs": t["ref_idxs"][pos], "ref_in_list": t["ref_in_list"][pos],
            "ref_valid_flow": t["ref_valid_flow"][pos],
            "scale_mat": t["eye"],
            "world_mat": t["eye"] if s1 else t["world_mat"][pos],
            "query_time_step": t["time"][pos] if s1 else t["world_time"],
            "world_time_step": t["world_time"],
            "image_idx": t["image_idx"][pos],
            "world_cam_idx": t["world_cam_idx"],
            "near": float(self.cfg["rendering"]["depth_range"][0]),
            "far": float(self.cfg["rendering"]["depth_range"][1]),
            "cos_anneal_ratio": cos_anneal_ratio(
                it, self.cfg["neus_training"]["neus_anneal_end"]),
            "loss_weights": weights,
            "lr": float(tr["learning_rate"]),
            "motion_lr": float(tr["pose_learning_rate"]),
        }

    def unit(self):
        if not self.queue:
            self.queue = list(self.order.permutation(len(self.i_train)))
        pos = int(self.queue.pop(0))
        self.it += 1
        batch = self.batch(pos, self.it)
        self.gen.manual_seed(iter_seed(self.seed, self.it))
        metrics = self.step(self.state, batch, self.gen)
        self.losses.append(metrics["loss"])
        self.done.append((pos, self.it))

    def _named(self) -> dict:
        return {k.replace(".layers.", "."): p
                for k, p in self.state["fields"].named_parameters()
                if not k.startswith("nerf.")}

    def _state_of(self, params: dict) -> dict:
        """Each leaf's value and Adam moments and count, copied."""
        out = {}
        for k, p in params.items():
            st = {}
            for opt in (self.state["opt_fields"], self.state["opt_motion"]):
                st = opt.state.get(p) or st
            out[k] = (p.detach().clone(),
                      st["exp_avg"].clone() if st else None,
                      st["exp_avg_sq"].clone() if st else None,
                      int(st["step"]) if st else 0)
        return out

    def warm_up(self):
        """The first steps, each read from the state it starts from: its
        loss, the first gradient as the optimizer got it, each step's change
        of every leaf; then a few more steps."""
        params = self._named()
        states, grads, steps = [], {}, []
        for k in range(FIRST):
            states.append(self._state_of(params) if k else None)
            before = {n: p.detach().clone() for n, p in params.items()}
            self.unit()
            if k == 0:
                grads = {n: norm(m / 0.1)
                         for n, (_, m, _, _) in self._state_of(params).items()
                         if m is not None}
            steps.append({n: norm(p.detach() - before[n])
                          for n, p in params.items()})
        self.states = states
        self.readings = step_readings(
            [float(x) for x in torch.stack(self.losses[:FIRST]).cpu()],
            grads, steps)
        for _ in range(int(self.mix["warmup_units"])):
            self.unit()
        self.first = len(self.losses)

    def counts(self):
        """(units run in the window, units whose loss is not finite)."""
        losses = torch.stack(self.losses[self.first:]).cpu()
        return len(losses), int((~torch.isfinite(losses)).sum())

    def release(self):
        del self.state, self.step
        self.losses = []

    def reference(self, precision="f32") -> dict:
        """The first steps recomputed, each from the state the program's
        step started from: the first from the benchmark's weights, the later
        ones from the program's leaves and Adam moments as the step before
        left them (a chaotic training run parts two f32 computations within
        a few steps, so each step is held to its own start)."""
        losses, grads0, steps = [], None, []
        for k, (pos, it) in enumerate(self.done[:FIRST]):
            w = clone(self.weights0)
            names = scene.leaves(w)
            state = self.states[k]
            with torch.no_grad():
                for n, t in names.items():
                    if state is not None:
                        t.copy_(state[n][0])
            before = {n: t.detach().clone() for n, t in names.items()}
            for t in names.values():
                t.requires_grad_(True)
            groups = [{n: v for n, v in names.items()
                       if not n.startswith("motion.")}]
            if self.static["train_motion"]:
                groups.append({n: v for n, v in names.items()
                               if n.startswith("motion.")})
            opts = []
            for leaves_ in groups:
                opt = ref_train.Adam(leaves_)
                if state is not None:
                    for n in leaves_:
                        _, m, v, count = state[n]
                        if m is not None:
                            opt.m[n], opt.v[n] = m.clone(), v.clone()
                            opt.count = count
                opts.append(opt)
            batch = self.batch(pos, it)
            self.gen.manual_seed(iter_seed(self.seed, it))
            ray_idx = ref_train.sample_patches(
                self.gen, self.h, self.w, self.static["patch_size"],
                self.rays_per_unit, self.device)
            t_rand = torch.rand(
                (self.rays_per_unit, self.cfg["neus_renderer"]["n_samples"]),
                generator=self.gen, device=self.device)
            with tf32(precision, self.device):
                total = ref_train.loss(w, self.cfg, self.static, batch,
                                       ray_idx, t_rand, precision)
                keys = list(names)
                gs = torch.autograd.grad(total, [names[n] for n in keys],
                                         allow_unused=True)
            grads = dict(zip(keys, gs))
            losses.append(float(total.detach()))
            stepped = {n for opt in opts for n in opt.leaves}
            if grads0 is None:
                grads0 = {n: norm(g) for n, g in grads.items()
                          if g is not None and n in stepped}
            for opt, lr in zip(opts, (batch["lr"], batch["motion_lr"])):
                opt.step({n: grads[n] for n in opt.leaves
                          if grads[n] is not None}, lr)
            steps.append({n: norm(t.detach() - before[n])
                          for n, t in names.items()})
        return step_readings(losses, grads0, steps)

    def unit_flop(self) -> float:
        """The model's operations in one step (``work.train_step_flop``)."""
        return work.train_step_flop(self.cfg, self.rays_per_unit, self.stage1,
                                    self.static["train_motion"],
                                    self.n_frames)

    compare = staticmethod(compare_steps)
