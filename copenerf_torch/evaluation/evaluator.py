"""The evaluation stack (port of ``copenerf_tpu/evaluation/evaluator.py``):
test-time pose optimization, novel-view rendering, the NVS / depth / pose
metrics and the artifacts.

As the reference's ``eval.py`` ``Evaluator``: each test view's pose starts
from the refined pose of the train view before it and is optimized by the
photometric loss alone (:44-93); the views are rendered at the world
camera's time (:95-188); the metrics follow the CF3DGS protocol (:190-256).

On a CUDA device a pose step runs four value sweeps (K2), the render-core
forward (K1-fwd) and its backward (K1-bwd), whose x / dirs gradients carry
the pose gradient; a rendered chunk runs four K2 and one K1-fwd. The field
weights stay frozen through the optimization: only ``r`` and ``t`` of the
test views get gradients.

Under torchrun every rank optimizes the test poses, as the JAX evaluator
does in each process; rank 0's poses are then broadcast, the test views
are rendered split over the ranks, and the metrics and every file come
from rank 0 alone (``io_primary``; the JAX evaluator writes from every
process).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..ops.rays import rays_from_pixels
from ..ops.renderer import render
from ..poses.lie import make_c2w
from ..poses.retriever import pose_retriever_all, pose_retriever_init
from ..training.checkpoints import load_pytree, save_pytree
from ..training.depth_metrics import compute_depth_errors
from ..training.schedules import MultiStepLR
from ..training.step import sample_patch_indices
from ..training.trainer import Trainer
from ..utils.profiling import spanned
from .metrics_image import lpips_fn, psnr, ssim
from .metrics_pose import pose_error_report

# The extraction folders ``eval`` writes, one file per test view in each.
EXTRACTION_DIRS = ("images_gt", "images", "depths", "depths_raw", "normal",
                   "disparity_highest_weight")
DEPTH_METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def init_positions(test_idx, i_train) -> list:
    """Each test frame's train position to start its pose from: the train
    frame just before it (reference ``eval.py:57``), else the nearest
    preceding train frame, else the nearest one (the reference throws for
    splits where the frame before a test frame is not a train frame)."""
    i_train = [int(j) for j in i_train]

    def position(ti):
        if (ti - 1) in i_train:
            return i_train.index(ti - 1)
        preceding = [j for j in i_train if j < ti]
        anchor = preceding[-1] if preceding else min(
            i_train, key=lambda j: abs(j - ti))
        return i_train.index(anchor)

    return [position(int(ti)) for ti in test_idx]


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """The module's parameters take no gradient inside the block; their
    ``requires_grad`` flags are restored after."""
    params = list(module.parameters())
    saved = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, saved):
            p.requires_grad_(flag)


@spanned("copenerf.pose.loss")
def pose_loss(fields, rcfg, r, t, init_c2w, image, camera_mat, ray_idx,
              time_step, near, far, *, generator=None, t_rand=None):
    """(L1 loss, l2) of one test view's pose ``make_c2w(r, t) @ init_c2w``
    on the rays ``ray_idx`` of its (3, H, W) image: the rays rendered with
    jitter (``t_rand``, or drawn from ``generator``) at ``time_step``; the
    loss the summed L1 over the rays' count, the l2 detached."""
    h, w = image.shape[1:]
    row = torch.div(ray_idx, w, rounding_mode="floor").float()
    col = (ray_idx % w).float()
    p_norm = torch.stack([2.0 * col / (w - 1) - 1.0,
                          2.0 * row / (h - 1) - 1.0], dim=-1)
    rgb_gt = image.reshape(3, h * w)[:, ray_idx].T
    world = make_c2w(r, t) @ init_c2w
    eye = torch.eye(4, dtype=world.dtype, device=world.device)
    rays_o, rays_d, rays_d_norm = rays_from_pixels(p_norm, camera_mat, world,
                                                   eye)
    out = render(fields, rays_o, rays_d, rays_d_norm, time_step, near, far,
                 rcfg=rcfg, cos_anneal_ratio=1.0, train=True,
                 generator=generator, t_rand=t_rand)
    diff = out["color_fine"] - rgb_gt
    return (torch.sum(torch.abs(diff)) / ray_idx.shape[0],
            torch.mean(diff.detach() ** 2))


class Evaluator(Trainer):
    def __init__(self, cfg: dict, device="cuda", verbose: bool = True):
        super().__init__(cfg, device=device, verbose=verbose)
        self._load_refine_pose()   # the train views' poses: refined_c2w
        # Injected (ray_idx, t_rand) per pose-step iteration, for the
        # cross-package tests; None samples from the generator.
        self.eval_inject_streams = None
        # Filled by eval_optimization: the lr of each epoch and the
        # photometric l2 of each step (copied to the host at the end).
        self.eval_lr_trace = []
        self.eval_l2_trace = None
        self.pose_retriever_test = None   # ({"r", "t"}, init_c2w)

    # ------------------------------------------------------------------
    def eval_optimization(self):
        """Optimize the test views' poses by the rgb loss (reference
        eval.py:44-93); cached at models/weights/model_eval_pose.npz as
        ``{r, t, init}``, the JAX package's layout."""
        dev = self.device
        cache = os.path.join(self.out_dir, "models", "weights",
                             "model_eval_pose.npz")
        test_idx = [int(i) for i in self.test_field.i_test]
        init_pos = init_positions(test_idx, self.train_field.i_train)
        init_c2w = torch.from_numpy(self.refined_c2w[init_pos]).to(dev)

        # Rank 0's view of the cache decides for every rank.
        found = bool(self._from_rank0(torch.tensor(float(os.path.isfile(cache)))))
        if found:
            self._log("Found optimized test poses")
            blob = load_pytree(cache)
            params = {k: torch.as_tensor(blob[k], dtype=torch.float32,
                                         device=dev) for k in ("r", "t")}
            self.pose_retriever_test = (
                {k: self._from_rank0(v) for k, v in params.items()},
                torch.as_tensor(blob["init"], dtype=torch.float32,
                                device=dev))
            return

        pose, _ = pose_retriever_init(len(test_idx), init_c2w, device=dev)
        r = pose["r"].requires_grad_(True)
        t = pose["t"].requires_grad_(True)
        # One Adam over the whole (n_test, 3) tensors: a step also moves
        # the views it did not sample, through their moments, as optax's
        # scale_by_adam over the pytree does.
        opt = torch.optim.Adam([r, t], lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        n_points = int(self.tr["n_training_points"])
        h, w = self.h, self.w
        fields = self.state["fields"]
        test_images = torch.from_numpy(
            np.asarray(self.test_field.imgs, np.float32)).to(dev)
        test_k = torch.from_numpy(np.asarray(
            self.test_field.K[self.test_field.i_test], np.float32)).to(dev)
        ones = torch.ones((n_points, 1), dtype=torch.float32, device=dev)
        near = ones * float(self.depth_range[0])
        far = ones * float(self.depth_range[1])
        inject = self.eval_inject_streams is not None

        def pose_step(view, it):
            if inject:
                ray_idx, t_rand = self.eval_inject_streams[it - 1]
                ray_idx = torch.as_tensor(ray_idx).to(dev).long()
                t_rand = torch.as_tensor(t_rand).to(dev).float()
            else:
                self.generator.manual_seed(
                    self.seed * 2 ** 32 + 10_000_000 + it)
                ray_idx = sample_patch_indices(self.generator, h, w, 1,
                                               n_points, device=dev)
                t_rand = None
            loss, l2 = pose_loss(
                fields, self.rcfg, r[view], t[view], init_c2w[view],
                test_images[view], test_k[view], ray_idx,
                self._world_time_dev, near, far, generator=self.generator,
                t_rand=t_rand)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return l2

        num_epoch = int(self.cfg["eval"]["eval_pose_epoch"])
        # Reference eval.py:55-56: MultiStepLR(milestones=range(0, E, E/5),
        # gamma); milestone 0 already decays epoch 0 (torch semantics).
        sched = MultiStepLR(
            float(self.cfg["eval"]["eval_pose_lr"]),
            range(0, num_epoch, max(num_epoch // 5, 1)),
            float(self.cfg["eval"]["eval_pose_scheduler_gamma"]))
        self._log("Optimizing test-view poses")
        it = 0
        self.eval_lr_trace = []
        l2_all = []
        with frozen(fields):
            for epoch in range(num_epoch):
                lr = sched.epoch_lr(epoch)
                self.eval_lr_trace.append(lr)
                for group in opt.param_groups:
                    group["lr"] = lr
                l2s = []
                for view in range(len(test_idx)):
                    it += 1
                    l2s.append(pose_step(view, it))   # stays on the device
                l2_all.extend(l2s)
                if epoch % 10 == 0:
                    # One host copy every 10 epochs.
                    l2 = float(torch.stack(l2s).mean())
                    self._log(f"eval pose epoch {epoch}: psnr "
                              f"{-10 * np.log10(max(l2, 1e-10)):.2f}")
        self.eval_l2_trace = (torch.stack(l2_all).cpu().numpy() if l2_all
                              else np.zeros((0,), np.float32))
        # The split render needs the same poses on every rank: rank 0's.
        params = {"r": self._from_rank0(r.detach()),
                  "t": self._from_rank0(t.detach())}
        self.pose_retriever_test = (params, init_c2w)
        if self.io_primary:
            save_pytree(cache, {"r": params["r"].cpu().numpy(),
                                "t": params["t"].cpu().numpy(),
                                "init": init_c2w.cpu().numpy()})

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_eval(self):
        """Render every test view at the world camera's time
        (eval.py:95-188): (gt images (H, W, 3), gt depths or None, the
        renders)."""
        params, init_c2w = self.pose_retriever_test
        test_poses = pose_retriever_all(params, init_c2w).cpu().numpy()
        eye = np.eye(4, dtype=np.float32)
        gt_imgs, gt_depths, preds = [], [], []
        for pos, target in enumerate(self.test_field.i_test):
            target = int(target)
            preds.append(self.image_renderer.render_image(
                self.state["fields"], self.test_field.K[target],
                test_poses[pos], eye, self.world_time_step, (self.h, self.w),
                self.depth_range, 1.0))
            # The image by position, the depth by frame, as the JAX
            # package indexes them.
            gt_imgs.append(np.transpose(self.test_field.imgs[pos], (1, 2, 0)))
            gt_depths.append(self.test_field.gt_depths[target]
                             if len(self.test_field.gt_depths) != 0 else None)
        return gt_imgs, gt_depths, preds

    # ------------------------------------------------------------------
    @torch.no_grad()
    def image_eval(self, gt_imgs, preds) -> dict:
        """PSNR, SSIM and LPIPS, means over the test views, on the device."""
        lpips = lpips_fn(device=self.device)
        psnrs, ssims, lpipss = [], [], []
        for gt, res in zip(gt_imgs, preds):
            pred = torch.from_numpy(np.ascontiguousarray(
                np.transpose(res["color"], (2, 0, 1)), np.float32)).to(
                    self.device)
            ref = torch.from_numpy(np.ascontiguousarray(
                np.transpose(gt, (2, 0, 1)), np.float32)).to(self.device)
            psnrs.append(float(psnr(pred, ref)))
            ssims.append(float(ssim(pred, ref)))
            if lpips is not None:
                lpipss.append(lpips(pred, ref))
        out = {"PSNR": float(np.mean(psnrs)), "SSIM": float(np.mean(ssims))}
        if lpipss:
            out["LPIPS"] = float(np.mean(lpipss))
        else:
            # The protocol's metric triple is PSNR / SSIM / LPIPS: a missing
            # one is reported loudly, as NaN (a number, so that consumers
            # of results.txt keep parsing it).
            self._log("WARNING: LPIPS unavailable (no VGG weights) — "
                      "results omit the third protocol metric. Provide "
                      "weights via COPENERF_LPIPS_VGG/COPENERF_LPIPS_LIN.")
            out["LPIPS"] = float("nan")
        return out

    def depth_eval(self, gt_depths, preds, min_depth=0.1, max_depth=80.0):
        """The 7 depth metrics, means over the views with ground truth."""
        if all(g is None for g in gt_depths):
            return None
        errors = []
        for gt, res in zip(gt_depths, preds):
            if gt is None:
                continue
            if self.cfg["dataloading"]["crop_size"] != 0:
                gt = gt[6:-6, 8:-8]  # eval.py:229-231 ScanNet crop quirk
            errors.append(compute_depth_errors(
                gt, res["depth"], min_depth, max_depth, clamp_pred=True))
        return dict(zip(DEPTH_METRICS,
                        np.mean(np.array(errors), axis=0).tolist()))

    def pose_eval(self) -> dict:
        """ATE and RPE of the train views' refined poses (those of
        ``refine_pose.npz``) against the ground truth."""
        pred = np.linalg.inv(self.refined_c2w)
        _, rpe_t, rpe_r, ate = pose_error_report(pred, self.gt_poses)
        return {"rpe_trans": rpe_t, "rpe_rot": rpe_r, "ate": ate}

    # ------------------------------------------------------------------
    def eval(self, store_output: bool = True) -> dict | None:
        """The metrics (and, with ``store_output``, the extraction folders)
        on rank 0; the other ranks take part in the renders and return
        None."""
        self.eval_optimization()
        gt_imgs, gt_depths, preds = self.render_eval()
        if not self.io_primary:
            return None
        result = {}
        result.update(self.image_eval(gt_imgs, preds))
        result.update(self.pose_eval())
        depth_result = self.depth_eval(gt_depths, preds)
        if depth_result is not None:
            result.update(depth_result)
        self._log(f"results: {result}")
        with open(os.path.join(self.out_dir, "results.txt"), "w") as f:
            for k, v in result.items():
                f.write(f"{k}: {v}\n")
        if store_output:
            self._store_extraction(gt_imgs, preds)
        return result

    def _store_extraction(self, gt_imgs, preds):
        base = os.path.join(self.out_dir, "extraction")
        for sub in EXTRACTION_DIRS:
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for pos, target in enumerate(self.test_field.i_test):
            fid = str(int(target)).zfill(6)
            res = preds[pos]
            self._save_image(os.path.join(base, "images_gt", f"{fid}.jpg"),
                             gt_imgs[pos])
            self._save_image(os.path.join(base, "images", f"{fid}.jpg"),
                             res["color"])
            d = res["depth"]
            self._save_image(os.path.join(base, "depths", f"{fid}.jpg"),
                             d / max(d.max(), 1e-6))
            np.savez(os.path.join(base, "depths_raw", f"depth_{fid}.npz"),
                     pred=d)
            self._save_image(os.path.join(base, "normal", f"{fid}.jpg"),
                             np.clip(res["normal"] * 0.5 + 0.5, 0, 1))
            dh = 1.0 / np.maximum(res["depth_highest"], 1e-6)
            self._save_image(
                os.path.join(base, "disparity_highest_weight", f"{fid}.jpg"),
                dh / max(dh.max(), 1e-6))
