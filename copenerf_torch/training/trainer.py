"""Training orchestration, both stages (port of
``copenerf_tpu/training/trainer.py``).

Host-side mirror of the reference training script's epoch loop: coarse-to-fine
resolution schedule, loss-weight annealing, lr warmup / drops / MultiStep
decay (``schedules.LRState``), pose evaluation, visualization with the
adaptive depth range, and checkpoint / resume in the JAX package's flat-npz
layout (``step.train_state_to_jax``), so a run started in either package
resumes in the other.

At ``start_query_world_epoch`` the stage-1 -> stage-2 transition renders
every train view's depth, refines the relative poses of consecutive views
by a photometric warp (``pose_refinement.py``), re-anchors them on the world
camera and writes them to ``models/refine_pose.npz`` (the JAX package's
layout). Stage 2 queries the field at the world camera's time through each
view's refined pose, kept on the device as one (M, 4, 4) table, with the
motion net frozen for ``freeze_camera_pose_period`` epochs.

Every iteration is one call of the port's train step (``step.py``): on a
CUDA device four value sweeps (K2), the render-core forward and backward
(K1) and, in stage 1, the sdf-consistency query and its backward (K3). The
loop adds no host synchronization per step: the scene and the per-view
tensors stay on the device, the step's metrics stay there until one copy
per epoch, and a Python float is taken only on ``print_every`` iterations.

Randomness: ``np.random`` is seeded once and draws one view permutation per
epoch (a resume replays the draws of the epochs already trained); each
iteration's patches and jitter come from a device generator seeded from
``(seed, it)``. A resumed port run therefore repeats an uninterrupted one.

Not ported yet: ``extract_geometry`` (the mesher) and multi-GPU training;
``io_primary`` gates every file write for the latter.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..data.fields import get_data_fields
from ..device import resolve_device
from ..evaluation.metrics_pose import pose_error_report
from ..evaluation.render import ImageRenderer
from ..models.fields import configs_from_cfg, init_all_fields, motion_apply
from ..models.torch_io import load_pretrained_sdf
from ..ops.renderer import RendererConfig
from ..poses.motion import full_video_w2c
from ..poses.retriever import pose_retriever_all, pose_retriever_init
from ..utils.profiling import StepTimer, synchronize, trace
from .checkpoints import (load_checkpoint, load_pytree, save_checkpoint,
                          save_pytree)
from .logging_utils import ScalarLogger
from .pose_refinement import motion_init_relative_poses, run_pose_refinement
from .schedules import LRState, cos_anneal_ratio, scalar_annealing
from .step import (StepStatic, build_train_step, init_train_state,
                   make_loss_weights, migrate_train_state,
                   train_state_from_jax, train_state_to_jax)

# The per-iteration scalars kept for the epoch's one host copy.
EPOCH_METRICS = ("loss", "loss_rgb", "loss_eikonal", "l2_mean", "loss_sdf",
                 "loss_flow_rgb", "sdf_consistency_loss",
                 "edge_aware_smoothness_loss", "smoothness_loss")
# Iterations of the torch.profiler window that starts at profile_trace_at_it.
TRACE_ITERS = 5


class Trainer:
    def __init__(self, cfg: dict, device="cuda", verbose: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        tr = cfg["training"]
        self.tr = tr
        self.verbose = verbose
        fused = tr.get("fused_kernels", "auto")
        if fused not in ("auto", "on"):
            # YAML reads a bare `off` as False.
            raise ValueError(
                f"training.fused_kernels={fused!r}: the port has no plain "
                "mode; a CUDA tensor reaches its kernel, a CPU tensor (pass "
                "device='cpu') takes the plain versions")
        self.out_dir = tr["out_dir"]
        self.render_path = os.path.join(self.out_dir, "rendering")
        # One writer: every file artifact is written only where io_primary
        # holds (always here; the multi-GPU slice gates it per process).
        self.io_primary = True
        if self.io_primary:
            os.makedirs(os.path.join(self.out_dir, "models"), exist_ok=True)
            os.makedirs(self.render_path, exist_ok=True)

        self.seed = tr["seed"]
        np.random.seed(self.seed)
        self.generator = torch.Generator(device=self.device)
        self.field_cfgs = configs_from_cfg(cfg)
        self.rcfg = RendererConfig.from_cfg(cfg)

        fields = init_all_fields(self.field_cfgs,
                                 torch.Generator().manual_seed(self.seed),
                                 device=self.device)
        sdf_path = tr.get("pretrained_sdf_path")
        if sdf_path and os.path.isfile(sdf_path):
            load_pretrained_sdf(fields["sdf"], sdf_path)
            self._log("Loaded pretrained SDF warm start")

        # Coarse-to-fine schedule {scale: [start, end]}.
        self.coarse_to_fine = dict(tr.get("coarse_to_fine_scheduler") or {})
        if not self.coarse_to_fine:
            self.coarse_to_fine = {1: [0, int(1e10)]}
        self.s = 1

        self.original_resolution = list(tr["original_resolution"])
        self.resolution = list(tr["resolution"])
        self._build_datasets(self.resolution)

        self.total_nb_images = self.train_field.total_nb_images
        self.gt_poses = self.train_field.c2ws.astype(np.float32)

        # World camera anchor (reference train.py:85-91).
        if tr["world_idx"] == "mid":
            wci = self.total_nb_images // 2
        else:
            wci = int(tr["world_idx"])
        while wci not in self.train_field.i_train:
            wci -= 1
        self.world_cam_idx = wci
        self.world_time_step = wci / (self.total_nb_images - 1) * 2.0 - 1.0
        self._world_cam_dev = torch.tensor(wci, device=self.device)
        self._world_time_dev = torch.tensor(self.world_time_step,
                                            dtype=torch.float32,
                                            device=self.device)
        self._eye = torch.eye(4, device=self.device)

        self.state = init_train_state(fields)
        self.depth_range = list(cfg["rendering"]["depth_range"])

        # Resume from a checkpoint of either package.
        self.epoch_it, self.it = -1, -1
        self.checkpoint_loaded = False
        try:
            tree, scalars = load_checkpoint(
                self.out_dir, model_only=tr["load_ckpt_model_only"])
            self.state = train_state_from_jax(migrate_train_state(tree),
                                              self.field_cfgs, self.device)
            if not tr["load_ckpt_model_only"]:
                self.epoch_it = int(scalars.get("epoch_it", -1))
                self.it = int(scalars.get("it", -1))
                if "depth_range" in scalars:
                    self.depth_range = list(scalars["depth_range"])
            self.checkpoint_loaded = True
            self._log("Checkpoint found ==> continue training")
        except FileNotFoundError:
            self._log("No checkpoint found ==> train from scratch")

        self.lr_state = LRState(tr)
        self.logger = ScalarLogger(self.out_dir, enabled=self.io_primary)
        self.step_timer = StepTimer(
            window=50,
            log_path=(os.path.join(self.out_dir, "logs", "throughput.jsonl")
                      if self.io_primary else None))
        # Set to an iteration number to capture a torch.profiler trace of
        # TRACE_ITERS iterations from there into logs/plugins; its summary
        # (wall time, device busy share, both also outside the
        # visualizations) lands in profile_summary and throughput.jsonl.
        self.profile_trace_at_it = tr.get("profile_trace_at_it", -1)
        self.profile_summary = None
        self.anneal_end = cfg["neus_training"]["neus_anneal_end"]

        self.patch_size = tr["patch_size"]
        self.n_ref = len(cfg["dataloading"]["random_ref_interval"])
        self.nb_sample_timestep = tr["nb_sample_timestep"]
        self.start_query_world_epoch = tr["start_query_world_epoch"]
        self.freeze_camera_pose_period = tr["freeze_camera_pose_period"]
        self.end_smooth_epoch = tr["end_smooth_epoch"]
        self.scheduling_start = tr["scheduling_start"]
        self.scheduling_epoch = tr["scheduling_epoch"]
        self.print_every = tr["print_every"]
        self.checkpoint_every = tr["checkpoint_every"]
        self.eval_pose_every = tr["eval_pose_every"]

        # Current loss weights (stage-[0] entries; annealing below mirrors
        # loss_weight_scalar_annealing, train.py:251-263).
        self.w_rgb = tr["rgb_weight"][0]
        self.w_eik = tr["eikonal_weight"][0]
        self.w_sdf = tr["sdf_weight"][0]
        self.w_flow_rgb = tr["flow_rgb_weight"][0]
        self.w_sdf_cons = tr["sdf_consistency_weight"][0]
        self.w_edge = tr["edge_aware_smoothness_weight"][0]
        self.w_smooth = tr["smoothness_weight"][0]

        # Rays per step: the reference's protocol is n_training_points
        # (1024); every loss term is a per-ray mean, so rays_per_step scales
        # the batch without changing the objective in expectation.
        self.rays_per_step = int(tr.get("rays_per_step") or
                                 tr["n_training_points"])
        if self.rays_per_step % (self.patch_size ** 2) != 0:
            raise ValueError(
                f"rays_per_step={self.rays_per_step} must be a multiple of "
                f"patch_size^2={self.patch_size ** 2}")
        self.image_renderer = ImageRenderer(
            self.rcfg, chunk=tr.get("render_chunk", 32768), device=self.device)
        self._steps = {}
        self.query_in_canonical_space = False
        # Stage 2: each train view's refined pose, (M, 4, 4) on the device
        # (the world camera's row the identity); whether the transition fell
        # back to the motion-integrated poses; the transition's times.
        self._world_mat_dev = None
        # The same poses on the host as refine_pose.npz holds them, the
        # world camera's row re-anchored to the identity only to rounding:
        # the evaluator's train poses, as the JAX package reads them.
        self.refined_c2w = None
        self.pose_refine_fell_back = False
        self.transition_summary = None

    # ------------------------------------------------------------------
    def _log(self, msg):
        if self.verbose:
            print(f"[trainer] {msg}")

    def _build_datasets(self, resolution):
        cfg = dict(self.cfg)
        cfg["training"] = dict(self.cfg["training"])
        cfg["training"]["resolution"] = list(resolution)
        self.cfg["training"]["resolution"] = list(resolution)
        self.train_field = get_data_fields(cfg, "train")["img"]
        self.test_field = get_data_fields(cfg, "eval")["img"]
        self.resolution = list(resolution)
        self.h, self.w = int(resolution[0]), int(resolution[1])
        dev = self.device
        # The scene stays on the device as uint8 (the step converts the
        # images it gathers).
        self.images_all_dev = torch.from_numpy(
            np.clip(self.train_field.all_imgs * 255.0 + 0.5, 0,
                    255).astype(np.uint8)).to(dev)
        self.K_all_dev = torch.from_numpy(
            np.asarray(self.train_field.K, np.float32)).to(dev)
        # Per train view: its reference masks, frame index and time, on the
        # device, so a step's batch is views of them (no host copy).
        m = self.train_field.N_imgs
        n_ref = len(self.train_field.random_ref_interval)
        self.ref_idxs = np.zeros((m, n_ref), np.int32)
        self.ref_in_list = np.zeros((m, n_ref), np.float32)
        self.ref_valid_flow = np.zeros((m, n_ref), np.float32)
        for pos, target in enumerate(self.train_field.i_train):
            _, idxs, in_list, valid, _ = self.train_field.ref_tensors(
                int(target), n_ref)
            self.ref_idxs[pos] = idxs
            self.ref_in_list[pos] = in_list
            self.ref_valid_flow[pos] = valid
        n_frames = self.train_field.total_nb_images
        targets = np.asarray(self.train_field.i_train, np.int64)
        self._ref_idxs_dev = torch.from_numpy(
            self.ref_idxs.astype(np.int64)).to(dev)
        self._ref_in_list_dev = torch.from_numpy(self.ref_in_list).to(dev)
        self._ref_valid_flow_dev = torch.from_numpy(
            self.ref_valid_flow).to(dev)
        self._image_idx_dev = torch.from_numpy(targets).to(dev)
        self._time_dev = torch.from_numpy(
            (targets / (n_frames - 1) * 2.0 - 1.0).astype(np.float32)).to(dev)

    def _scale_for_epoch(self, epoch):
        for s, interval in self.coarse_to_fine.items():
            if interval[0] <= epoch <= interval[1]:
                return int(s)
        return int(list(self.coarse_to_fine.keys())[-1])

    def _get_step(self, stage1: bool, train_motion: bool):
        """The train step for the current resolution, patch size and scale:
        the one place steps are built (``step(state, batch, generator) ->
        metrics``)."""
        key = (self.h, self.w, self.patch_size, stage1, train_motion, self.s)
        if key not in self._steps:
            static = StepStatic(
                h=self.h, w=self.w, patch_size=self.patch_size,
                n_points=self.rays_per_step, stage1=stage1,
                n_images=self.total_nb_images,
                nb_sample_timestep=self.nb_sample_timestep,
                n_ref=self.n_ref, train_motion=train_motion,
                sdf_cons_pose_grad=self.tr["sdf_consistency_enable_pose_grad"],
                use_flow_rgb=(sum(self.tr["flow_rgb_weight"]) != 0),
                use_sdf_consistency=(
                    sum(self.tr["sdf_consistency_weight"]) != 0),
                smooth_scale=self.s)
            self._steps[key] = build_train_step(self.rcfg, static)
        return self._steps[key]

    def time_of(self, idx):
        return idx / (self.total_nb_images - 1) * 2.0 - 1.0

    # ------------------------------------------------------------------
    def _anneal_weights(self, it):
        tr = self.tr
        if tr["end_consistency_weight_increase_iteration"] != -1:
            self.w_sdf_cons = scalar_annealing(
                it, 0.0, tr["end_consistency_weight_increase_iteration"],
                tr["sdf_consistency_weight"][0],
                tr["sdf_consistency_weight"][1])
        if tr["end_sdf_weight_increase_iteration"] != -1:
            self.w_sdf = scalar_annealing(
                it, 0.0, tr["end_sdf_weight_increase_iteration"],
                tr["sdf_weight"][0], tr["sdf_weight"][1])

    def _make_batch(self, pos: int, lr: float, motion_lr: float):
        """The batch of train view ``pos``: device tensors (views of the
        per-view tables) and host scalars. Stage 2 queries at the world
        camera's time through the view's refined pose."""
        if self.query_in_canonical_space:
            world_mat, query_t = self._world_mat_dev[pos], self._world_time_dev
        else:
            world_mat, query_t = self._eye, self._time_dev[pos]
        return {
            "images_all": self.images_all_dev,
            "K_all": self.K_all_dev,
            "ref_idxs": self._ref_idxs_dev[pos],
            "ref_in_list": self._ref_in_list_dev[pos],
            "ref_valid_flow": self._ref_valid_flow_dev[pos],
            "scale_mat": self._eye,
            "world_mat": world_mat,
            "query_time_step": query_t,
            "world_time_step": self._world_time_dev,
            "image_idx": self._image_idx_dev[pos],
            "world_cam_idx": self._world_cam_dev,
            "near": float(self.depth_range[0]),
            "far": float(self.depth_range[1]),
            "cos_anneal_ratio": cos_anneal_ratio(self.it, self.anneal_end),
            "loss_weights": make_loss_weights(
                self.w_rgb, self.w_eik, self.w_sdf, self.w_flow_rgb,
                self.w_sdf_cons, self.w_edge, self.w_smooth),
            "lr": lr,
            "motion_lr": motion_lr,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def pose_evaluation(self):
        """Motion-field pose metrics vs GT on the train split
        (reference pose_evaluation, train.py:206-220)."""
        w2c = full_video_w2c(self.state["fields"]["motion"],
                             self.total_nb_images,
                             self.nb_sample_timestep).cpu().numpy()
        pred = np.linalg.inv(w2c[self.train_field.i_train])
        aligned, rpe_t, rpe_r, ate = pose_error_report(pred, self.gt_poses)
        self.logger.add_scalar("eval_pose/rpe_trans", rpe_t, self.epoch_it)
        self.logger.add_scalar("eval_pose/rpe_rot", rpe_r, self.epoch_it)
        self.logger.add_scalar("eval_pose/ate", ate, self.epoch_it)
        return aligned, rpe_t, rpe_r, ate

    def render_train_views(self, out_subdir="extraction_stage1", views=None):
        """No-grad render of the train views (all, or the train positions
        ``views``); returns their depths (reference render_train_views,
        train.py:288-305)."""
        ddir = os.path.join(self.out_dir, out_subdir, "depths")
        idir = os.path.join(self.out_dir, out_subdir, "images")
        if self.io_primary:
            os.makedirs(ddir, exist_ok=True)
            os.makedirs(idir, exist_ok=True)
        depths = []
        car = cos_anneal_ratio(self.it, self.anneal_end)
        positions = range(self.train_field.N_imgs) if views is None else views
        for pos in positions:
            target = int(self.train_field.i_train[pos])
            res = self.image_renderer.render_image(
                self.state["fields"], self.train_field.K[target],
                np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32),
                self.time_of(target), (self.h, self.w), self.depth_range,
                car)
            depth = res["depth"]
            depths.append(depth)
            if self.io_primary:
                np.savez(
                    os.path.join(ddir, f"depth_{str(target).zfill(6)}.npz"),
                    pred=depth)
                self._save_image(
                    os.path.join(idir, f"{str(target).zfill(6)}.png"),
                    res["color"])
        return np.stack(depths)

    @staticmethod
    def _save_image(path, img01):
        import cv2

        img = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        cv2.imwrite(path, img)

    # ------------------------------------------------------------------
    def stage2_transition(self, epoch_it: int):
        """Switch to canonical-space queries; refine and freeze the poses
        (reference train.py:360-399)."""
        self.query_in_canonical_space = True
        self.lr_state.on_epoch_start(epoch_it, stage2_starts_now=True)
        i_train = self.train_field.i_train
        pred_poses = None
        summary = {"epoch": epoch_it}
        if self.tr["do_refine_pose"]:
            # A resource failure mid-refinement (out of device or host
            # memory, IO) must not abort training at the stage boundary: it
            # falls back to the motion-integrated poses (the do_refine_pose
            # = false path), the information the refinement would have
            # started from. Nothing else is caught: a kernel's build or
            # launch error is a RuntimeError and propagates.
            try:
                self._log("Rendering train-view depths for pose refinement")
                t0 = time.perf_counter()
                depths = self.render_train_views()
                t1 = time.perf_counter()
                init_c2w = None
                if not self.tr["refine_from_scratch"]:
                    init_c2w = motion_init_relative_poses(
                        self.state["fields"]["motion"], i_train,
                        self.total_nb_images, self.nb_sample_timestep)
                self._log("Performing pose refinement")
                pred_poses = run_pose_refinement(
                    self.train_field.imgs, depths,
                    self.train_field.K[i_train][:, :3, :3],
                    init_c2w=init_c2w, lr=self.tr["pose_refine_lr"],
                    epochs=self.tr["pose_refine_epochs"], logger=self.logger,
                    gt_poses=self.gt_poses, pose_error_fn=pose_error_report,
                    device=self.device)
                # Both calls end in host copies: the host clock is the
                # device's too.
                summary.update(
                    render_train_views_ms=1e3 * (t1 - t0),
                    pose_refine_ms=1e3 * (time.perf_counter() - t1))
            except (torch.OutOfMemoryError, OSError, MemoryError) as exc:
                self._log(f"WARNING: pose refinement failed ({exc!r}); "
                          "falling back to motion-integrated poses")
                self.pose_refine_fell_back = True
                pred_poses = None
        if pred_poses is None:
            with torch.no_grad():
                w2c = full_video_w2c(self.state["fields"]["motion"],
                                     self.total_nb_images,
                                     self.nb_sample_timestep).cpu().numpy()
            pred_poses = np.linalg.inv(w2c[i_train])

        # Re-anchor on the world camera (train.py:395).
        world_pos = list(i_train).index(self.world_cam_idx)
        pred_poses = (np.linalg.inv(pred_poses) @
                      pred_poses[world_pos][None]).astype(np.float32)
        self._set_world_mats(pred_poses)
        self.refined_c2w = pred_poses
        if self.io_primary:
            save_pytree(self._refine_pose_path(), {"init_c2w": pred_poses})
        self.transition_summary = {**summary,
                                   "fell_back": self.pose_refine_fell_back}
        self.step_timer.log(self.it, transition=self.transition_summary)
        self._log(f"Start querying in canonical space at epoch {epoch_it}")

    def _refine_pose_path(self):
        return os.path.join(self.out_dir, "models", "refine_pose.npz")

    def _set_world_mats(self, init_c2w: np.ndarray):
        """The stage-2 ``world_mat`` table: the pose retriever's poses of
        every train view (its corrections are never trained), the world
        camera's row exactly the identity."""
        params_r, init = pose_retriever_init(len(init_c2w), init_c2w,
                                             device=self.device)
        with torch.no_grad():
            table = pose_retriever_all(params_r, init)
        table[list(self.train_field.i_train).index(self.world_cam_idx)] = \
            self._eye
        self._world_mat_dev = table

    def _load_refine_pose(self):
        """The refined poses of a run past its transition, from
        ``models/refine_pose.npz``; raises when the file is absent."""
        path = self._refine_pose_path()
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path}: a run past start_query_world_epoch="
                f"{self.start_query_world_epoch} needs the poses the stage-2 "
                "transition wrote")
        self.refined_c2w = np.asarray(load_pytree(path)["init_c2w"],
                                      np.float32)
        self._set_world_mats(self.refined_c2w)

    # ------------------------------------------------------------------
    def visualize(self, pos: int, epoch_it: int):
        """Periodic visualization + adaptive depth-range update
        (reference render_visdata, model/training.py:157-374). Stage 2
        renders at the world camera's time through the view's refined pose,
        and draws no flow."""
        target = int(self.train_field.i_train[pos])
        vis_res = self.tr["vis_resolution"]
        world_mat = np.eye(4, dtype=np.float32)
        query_t = self.time_of(target)
        if self.query_in_canonical_space and target != self.world_cam_idx:
            world_mat = self._world_mat_dev[pos].cpu().numpy()
            query_t = self.world_time_step
        want_flow = not self.query_in_canonical_space
        res = self.image_renderer.render_image(
            self.state["fields"], self.train_field.K[target], world_mat,
            np.eye(4, dtype=np.float32), query_t, vis_res, self.depth_range,
            cos_anneal_ratio(self.it, self.anneal_end), want_pts=want_flow)

        if self.io_primary:
            out_dir = os.path.join(self.render_path, f"{self.it:04d}_vis")
            os.makedirs(out_dir, exist_ok=True)
            if want_flow:
                try:
                    flow_img = self._flow_visualization(res, target, vis_res)
                    self._save_image(
                        os.path.join(out_dir, f"{target:04d}_flow.png"),
                        flow_img)
                except Exception as e:
                    self._log(f"flow vis failed: {e}")
            disp = 1.0 / np.maximum(res["depth"], 1e-6)
            disp = disp / max(disp.max(), 1e-6)
            self._save_image(os.path.join(out_dir, f"{target:04d}_img.png"),
                             res["color"])
            self._save_image(
                os.path.join(out_dir, f"{target:04d}_disparity.png"), disp)
            normal_img = np.clip(res["normal"] * 0.5 + 0.5, 0, 1)
            self._save_image(
                os.path.join(out_dir, f"{target:04d}_normal.png"), normal_img)
            disp_hw = 1.0 / np.maximum(res["depth_highest"], 1e-6)
            disp_hw = disp_hw / max(disp_hw.max(), 1e-6)
            self._save_image(
                os.path.join(out_dir,
                             f"{target:04d}_disparity_highest_weight.png"),
                disp_hw)

        # Adaptive depth range (model/training.py:339-355).
        depth_bound_lr = 0.0
        for mi, milestone in enumerate(
                self.tr["depth_bound_scheduler_milestones"]):
            if self.it >= milestone:
                depth_bound_lr = self.tr["depth_bound_lr"][mi]
        wz = res["weighted_z"]
        max_depth = float(wz.max()) * 1.1
        self.depth_range[1] = (self.depth_range[1] * (1 - depth_bound_lr) +
                               max_depth * depth_bound_lr)
        self.logger.add_scalar("stats/depth_running_max", self.depth_range[1],
                               self.it)

        # Depth metrics against GT during training (model/training.py:357-372).
        if len(self.train_field.gt_depths) != 0:
            from .depth_metrics import compute_depth_errors

            gt = self.train_field.gt_depths[target]
            names = ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"]
            errs = compute_depth_errors(gt, res["depth"])
            for name, val in zip(names, errs):
                self.logger.add_scalar(f"depth_eval/{name}", val, self.it)
        return res

    def _flow_visualization(self, res, target: int, vis_res):
        """Forward optical flow from integrated scene flow
        (reference render_visdata, model/training.py:264-303): advect each
        sample point along the motion field to the last ref frame's time,
        composite with render weights, reproject, color-code."""
        import cv2

        from ..ops.rays import arange_pixels

        h, w = int(vis_res[0]), int(vis_res[1])
        n_sub = self.nb_sample_timestep * self.train_field.random_ref_interval[-1]
        t0 = self.time_of(target)
        t1 = self.time_of(target + self.train_field.random_ref_interval[-1])
        times = np.linspace(t0, t1, n_sub + 1)[:-1].astype(np.float32)
        with torch.no_grad():
            omega, vel = motion_apply(
                self.state["fields"]["motion"],
                torch.from_numpy(times[:, None]).to(self.device))
        omega = omega.cpu().numpy()
        vel = vel.cpu().numpy()
        dt = (t1 - t0) / n_sub

        pts = res["pts_flat"].reshape(-1, 3)          # (h*w*S, 3)
        n_samples = res["weights_flat"].shape[1]
        for k in range(n_sub):
            flow = np.cross(np.broadcast_to(omega[k], pts.shape), pts) + vel[k]
            pts = pts + dt * flow
        weights = res["weights_flat"].reshape(h * w, n_samples, 1)
        pts_sf = (weights * pts.reshape(h * w, n_samples, 3)).sum(1)

        proj = self.train_field.K[target][:3, :3]
        pix = pts_sf @ proj.T
        pix2 = pix[:, :2] / np.where(np.abs(pix[:, 2:]) < 1e-8, 1e-8,
                                     pix[:, 2:])
        _, grid = arange_pixels((h, w))
        flow2d = pix2 - grid
        flow2d[:, 0] *= w / 2.0
        flow2d[:, 1] *= h / 2.0
        flow2d = flow2d.reshape(h, w, 2)

        mag, ang = cv2.cartToPolar(flow2d[..., 0], flow2d[..., 1])
        hsv = np.zeros((h, w, 3), np.uint8)
        hsv[..., 0] = (ang * 180 / np.pi / 2).astype(np.uint8)
        hsv[..., 1] = 255
        hsv[..., 2] = cv2.normalize(mag, None, 0, 255,
                                    cv2.NORM_MINMAX).astype(np.uint8)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0

    def vis_pose_2d(self, aligned_pred_pose: np.ndarray):
        """XY scatter of predicted vs GT camera centers
        (reference train.py:222-233); skipped without matplotlib."""
        if not self.io_primary:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            from matplotlib import pyplot as plt
        except Exception:
            return
        fig = plt.figure()
        plt.scatter(aligned_pred_pose[:, 0, -1], aligned_pred_pose[:, 1, -1])
        plt.scatter(self.gt_poses[:, 0, -1], self.gt_poses[:, 1, -1])
        plt.legend(["Pred", "Gt"])
        plt.title(f"Epoch: {self.epoch_it}")
        plt.xlabel("X-axis")
        plt.ylabel("Y-axis")
        vis_dir = os.path.join(self.out_dir, "poses_vis")
        os.makedirs(vis_dir, exist_ok=True)
        plt.savefig(os.path.join(vis_dir, f"{self.epoch_it}.jpg"),
                    bbox_inches="tight")
        plt.close(fig)

    # ------------------------------------------------------------------
    def prepare_training(self):
        self.current_epoch = self.epoch_it + 1 if self.epoch_it != -1 else 0
        self.query_in_canonical_space = (
            self.current_epoch >= self.start_query_world_epoch)
        s = self._scale_for_epoch(self.current_epoch)
        if s != 1 or self.resolution != [self.original_resolution[0] // s,
                                         self.original_resolution[1] // s]:
            new_res = [self.original_resolution[0] // s,
                       self.original_resolution[1] // s]
            self.s = s
            self._build_datasets(new_res)
        if self.current_epoch > self.end_smooth_epoch:
            self.w_smooth = self.tr["smoothness_weight"][1]
            self.w_edge = self.tr["edge_aware_smoothness_weight"][1]
            self.patch_size = 1
        # A resume past the transition trains on the refined poses, also
        # from a checkpoint saved in the transition epoch (the JAX package
        # loads them only from the epoch after that one, and trains that
        # one on the identity).
        if self.current_epoch > self.start_query_world_epoch:
            self._log("Loading pre-computed camera poses")
            self._load_refine_pose()
        # Rebuild the group-lr mutation sequence on resume (decays, drops,
        # warmup overwrites, the stage-2 reset; order matters, see LRState)
        # and replay the view permutations the trained epochs drew.
        for e in range(0, self.current_epoch):
            self.lr_state.replay_epoch(
                e, self.train_field.N_imgs,
                stage2_starts_now=(e == self.start_query_world_epoch))
            np.random.permutation(self.train_field.N_imgs)
        return self.resolution

    def train(self, max_epochs: int | None = None):
        self.prepare_training()
        stage = "2 (world)" if self.query_in_canonical_space else "1 (local)"
        self._log(f"Continue at epoch={self.current_epoch}, it={self.it}; "
                  f"resolution={self.resolution}; stage={stage}")

        end_epoch = self.scheduling_start + self.scheduling_epoch
        if max_epochs is not None:
            end_epoch = min(end_epoch, self.current_epoch + max_epochs)

        update_milestones = [v[0] for v in self.coarse_to_fine.values()]
        window = None
        try:
            for epoch_it in range(self.current_epoch, end_epoch):
                self.epoch_it = epoch_it
                self.lr_state.on_epoch_start(epoch_it, stage2_starts_now=False)

                if (len(self.coarse_to_fine) >= 2 and
                        epoch_it in update_milestones):
                    s = self._scale_for_epoch(epoch_it)
                    if s != self.s:
                        self.s = s
                        self._build_datasets(
                            [self.original_resolution[0] // s,
                             self.original_resolution[1] // s])
                        self._log(f"Resolution -> {self.resolution}")

                if epoch_it == self.start_query_world_epoch:
                    self.stage2_transition(epoch_it)

                if epoch_it == self.end_smooth_epoch:
                    self.w_smooth = self.tr["smoothness_weight"][1]
                    self.w_edge = self.tr["edge_aware_smoothness_weight"][1]
                    self.patch_size = 1
                    self._log(f"epoch {epoch_it}: smoothness off, patch_size=1")

                # The motion net is frozen for freeze_camera_pose_period
                # epochs from the transition: its Adam count stands still.
                freeze_pose = (self.start_query_world_epoch <= epoch_it <=
                               self.start_query_world_epoch +
                               self.freeze_camera_pose_period)
                step = self._get_step(
                    stage1=not self.query_in_canonical_space,
                    train_motion=not freeze_pose)
                perm = np.random.permutation(self.train_field.N_imgs)
                epoch_metrics = []
                vis_ms = 0.0
                synchronize(self.device)
                t_loop = time.perf_counter()
                for pos in perm:
                    self.it += 1
                    self._anneal_weights(self.it)
                    lr, motion_lr = self.lr_state.lrs(self.it)
                    batch = self._make_batch(int(pos), lr, motion_lr)
                    # The iteration's patches and jitter depend on (seed, it)
                    # alone, so a resumed run draws what an uninterrupted one
                    # does.
                    self.generator.manual_seed(self.seed * 2 ** 32 + self.it)
                    if self.it == self.profile_trace_at_it and self.io_primary:
                        window = contextlib.ExitStack()
                        summary = window.enter_context(trace(
                            os.path.join(self.out_dir, "logs", "plugins"),
                            self.device, annotation="visualize"))
                        first_traced = self.it
                    metrics = step(self.state, batch, self.generator)
                    self.step_timer.tick()
                    epoch_metrics.append(metrics)

                    if self.print_every > 0 and self.it % self.print_every == 0:
                        for k in ("loss", "loss_rgb", "loss_eikonal",
                                  "loss_sdf", "loss_flow_rgb",
                                  "sdf_consistency_loss"):
                            self.logger.add_scalar(f"loss/{k}",
                                                   float(metrics[k]), self.it)
                        for k in ("s_val", "cdf_fine", "weight_sum",
                                  "weight_max"):
                            self.logger.add_scalar(f"stats/{k}",
                                                   float(metrics[k]), self.it)
                        self.logger.add_scalar("lr/model", lr, self.it)
                        self.logger.add_scalar("lr/motion_net", motion_lr,
                                               self.it)

                    visualize_every = 0
                    for mi, milestone in enumerate(
                            self.tr["depth_bound_scheduler_milestones"]):
                        if self.it >= milestone:
                            visualize_every = self.tr[
                                "depth_bound_update_every_milestones"][mi]
                    if visualize_every > 0 and self.it % visualize_every == 0:
                        # The render ends in host copies anyway; draining the
                        # queued steps first makes its time its own.
                        synchronize(self.device)
                        t_vis = time.perf_counter()
                        try:
                            with record_function("visualize"):
                                self.visualize(int(pos), epoch_it)
                        except Exception as e:  # as the JAX Trainer does
                            self._log(f"visualization failed: {e}")
                        vis_ms += 1e3 * (time.perf_counter() - t_vis)

                    if (window is not None and self.it ==
                            first_traced + TRACE_ITERS - 1):
                        window.close()
                        window = None
                        self._trace_done(summary, first_traced)
                # One synchronization an epoch: the loop's time per iteration,
                # with and without the visualizations, for the journal.
                synchronize(self.device)
                loop_ms = 1e3 * (time.perf_counter() - t_loop)

                if (self.checkpoint_every > 0 and
                        epoch_it % self.checkpoint_every == 0 and epoch_it > 0):
                    self.save_checkpoint()

                # One host copy of every per-iteration scalar kept this epoch.
                values = torch.stack([
                    torch.stack([m[k] for m in epoch_metrics])
                    for k in EPOCH_METRICS]).cpu().numpy()
                epoch_losses = dict(zip(EPOCH_METRICS, values))
                # NaN hard abort (the reference asserts every iteration;
                # checking at the epoch's one host copy keeps the device
                # queue free of per-step synchronization).
                if not np.all(np.isfinite(epoch_losses["loss"])):
                    bad = int(np.flatnonzero(
                        ~np.isfinite(epoch_losses["loss"]))[0])
                    raise FloatingPointError(
                        f"non-finite training loss in epoch {epoch_it} "
                        f"(iteration {bad} of the epoch); aborting like the "
                        "reference NaN assert")
                l2_epoch = float(np.mean(epoch_losses["l2_mean"]))
                psnr = float(-10.0 * np.log10(max(l2_epoch, 1e-10)))
                self.logger.add_scalar("stats/psnr", psnr, epoch_it)
                for k, vals in epoch_losses.items():
                    self.logger.add_scalar(
                        f"loss_epoch/{k}", float(np.mean(vals)), epoch_it)
                self.step_timer.log(
                    self.it, epoch=epoch_it,
                    rays_per_sec=(self.step_timer.items_per_sec *
                                  self.rays_per_step),
                    ms_per_it=loop_ms / len(perm), vis_ms=vis_ms,
                    ms_per_it_steps=(loop_ms - vis_ms) / len(perm))

                if (epoch_it % self.eval_pose_every == 0 and
                        not self.query_in_canonical_space):
                    try:
                        aligned, _, _, _ = self.pose_evaluation()
                        self.vis_pose_2d(aligned)
                    except Exception as e:  # as the JAX Trainer does
                        self._log(f"pose eval failed: {e}")

                self.lr_state.on_epoch_end(epoch_it)
        finally:
            if window is not None:
                window.close()
                self._trace_done(summary, first_traced)
        self.logger.flush()

    def _trace_done(self, summary: dict, first_it: int):
        iters = self.it - first_it + 1
        self.profile_summary = {"first_it": first_it, "iters": iters,
                                "ms_per_it": summary["wall_ms"] / iters,
                                **summary}
        self.step_timer.log(self.it, profile=self.profile_summary)
        self._log(f"profiler trace of its {first_it}..{self.it}: "
                  f"busy share {summary['busy_share']:.3f}")

    def save_checkpoint(self):
        if not self.io_primary:
            return
        scalars = {"epoch_it": self.epoch_it, "it": self.it,
                   "depth_range": list(map(float, self.depth_range))}
        tree = train_state_to_jax(self.state)
        save_checkpoint(self.out_dir, tree, scalars, latest=True)
        save_checkpoint(self.out_dir, tree, scalars, latest=False,
                        epoch=self.epoch_it)
