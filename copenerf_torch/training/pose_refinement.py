"""Stage-1 -> stage-2 pose refinement (port of
``copenerf_tpu/training/pose_refinement.py``).

The relative poses between consecutive train views (optionally initialized
from the motion field) are optimized by a bidirectional depth-based
photometric warp, with a 50-epoch convergence window. The images, depths and
intrinsics stay on the device; a batch of pairs is gathered from them by an
index tensor, and its warp, bilinear sample and loss run batched over the
pairs. No kernel of the port is on this path: it is plain PyTorch on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.interp import grid_sample_bilinear_batched
from ..poses.lie import make_c2w, se3_inverse
from ..poses.motion import full_video_w2c, w2c_mappings
from .schedules import MultiStepLR


def _uv_grid(h: int, w: int) -> np.ndarray:
    """(3, h, w): x, y normalized to [-1, 1], ones."""
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    xs = xs / ((w - 1) / 2.0) - 1.0
    ys = ys / ((h - 1) / 2.0) - 1.0
    return np.stack([xs, ys, np.ones_like(xs)], 0)


def _warp_terms(img, next_img, depth, k33, uv, rel):
    """One direction of the photometric warp for a batch of B pairs.

    ``img``, ``next_img`` (B, 3, h, w); ``depth`` (B, h, w); ``k33``
    (B, 3, 3); ``uv`` (3, h, w); ``rel`` (B, 4, 4). Returns the masked
    abs-diff sum and the valid-pixel count of each pair, (B,) each; the
    caller forms the batch-wide ratio of their sums.
    """
    b = img.shape[0]
    xyz = torch.linalg.inv(k33) @ (uv[None] * depth[:, None]).reshape(b, 3, -1)
    tx = rel[:, :3, :3] @ xyz + rel[:, :3, 3:]
    uvt = k33 @ tx
    # Guard the projective division: points at z ~ 0 are invalid anyway, but
    # an exact 0/0 would poison the masked sum with NaNs.
    z = uvt[:, 2:]
    z_safe = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)
    uv2 = uvt[:, :2] / z_safe
    valid = ((uv2[:, 0].abs() <= 1.0) & (uv2[:, 1].abs() <= 1.0)).float()
    warped = grid_sample_bilinear_batched(next_img, uv2.transpose(1, 2))
    diff = (warped - img.reshape(b, 3, -1)).abs() * valid[:, None]
    return diff.sum((1, 2)), valid.sum(1)


def batched_warp_loss(images, next_images, depths, k33, uv, rels):
    """The warp loss of a pair batch: one ratio of batch-wide sums (not a
    mean of per-pair ratios)."""
    nums, dens = _warp_terms(images, next_images, depths, k33, uv, rels)
    return nums.sum() / (dens.sum() + 1e-10)


def run_pose_refinement(images, depths, k33_list, *, init_c2w=None,
                        lr: float = 1e-3, epochs: int = 2000,
                        batch_size: int = 16, logger=None, gt_poses=None,
                        pose_error_fn=None, log_prefix: str = "poseRefine",
                        convergence_std: float = 1e-5, device="cuda"):
    """Optimize the M-1 relative poses between consecutive train views.

    Args:
      images: (M, 3, h, w) train images (numpy or tensor).
      depths: (M, h, w) rendered stage-1 depths.
      k33_list: (M, 3, 3) NDC-style intrinsics.
      init_c2w: optional (M-1, 4, 4) initial relative poses.
      device: where the refinement runs (the inputs are copied there).
    Returns:
      (M, 4, 4) float32 camera-to-world poses (the inverse of the chained
      w2c), or None when ``epochs`` is 0.
    """
    dev = resolve_device(device)

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).detach()

    images, depths, k33 = on_device(images), on_device(depths), on_device(
        k33_list)
    n_pairs = images.shape[0] - 1
    h, w = depths.shape[1:]
    uv = on_device(_uv_grid(h, w))
    if init_c2w is None:
        init_c2w = torch.eye(4, device=dev).expand(n_pairs, 4, 4)
    else:
        init_c2w = on_device(init_c2w)

    # One tensor each: the rows of pairs outside a batch get zero gradients,
    # so Adam moves them through their moments as optax does.
    r = torch.zeros((n_pairs, 3), device=dev, requires_grad=True)
    t = torch.zeros((n_pairs, 3), device=dev, requires_grad=True)
    opt = torch.optim.Adam([r, t], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def refine_step(idx):
        rel = make_c2w(r[idx], t[idx]) @ init_c2w[idx]
        img, nxt = images[idx], images[idx + 1]
        dep, ndep = depths[idx], depths[idx + 1]
        kk = k33[idx]
        # Forward and backward warps each form one batch-wide masked
        # ratio; the loss averages the two directions.
        pos = batched_warp_loss(img, nxt, dep, kk, uv, rel)
        neg = batched_warp_loss(nxt, img, ndep, kk, uv, se3_inverse(rel))
        loss = (pos + neg) / 2.0
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def chained_poses():
        w2c = w2c_mappings(make_c2w(r, t) @ init_c2w).cpu().numpy()
        return np.linalg.inv(w2c).astype(np.float32)

    loss_window = []
    # MultiStepLR(milestones=range(30, 10000, 10), gamma=0.9), read per
    # epoch (torch decays the lr used in the milestone epoch).
    sched = MultiStepLR(lr, range(30, 10000, 10), 0.9)
    for epoch in range(epochs):
        cur_lr = sched.epoch_lr(epoch)
        for group in opt.param_groups:
            group["lr"] = cur_lr
        batch_losses, batch_sizes = [], []
        for start in range(0, n_pairs, batch_size):
            idx = torch.arange(start, min(start + batch_size, n_pairs),
                               device=dev)
            batch_losses.append(refine_step(idx))
            batch_sizes.append(len(idx))
        # One host copy an epoch (the convergence window needs the loss).
        running = float(np.dot(torch.stack(batch_losses).cpu().numpy(),
                               batch_sizes)) / n_pairs

        if logger is not None:
            logger.add_scalar(f"{log_prefix}/_loss", running, epoch)
            logger.add_scalar(f"{log_prefix}/lr", cur_lr, epoch)
            if gt_poses is not None and pose_error_fn is not None:
                _, rpe_t, rpe_r, ate = pose_error_fn(chained_poses(),
                                                     gt_poses)
                logger.add_scalar(f"{log_prefix}/rpe_trans", rpe_t, epoch)
                logger.add_scalar(f"{log_prefix}/rpe_rot", rpe_r, epoch)
                logger.add_scalar(f"{log_prefix}/ate", ate, epoch)

        if len(loss_window) >= 50:
            loss_window.pop(0)
        loss_window.append(running)
        if len(loss_window) == 50 and np.std(loss_window) <= convergence_std:
            break
    return chained_poses() if epochs > 0 else None


@torch.no_grad()
def motion_init_relative_poses(motion_net, i_train, total_nb_images,
                               nb_sample_timestep):
    """(M-1, 4, 4) initial relative poses between consecutive train views
    from the motion field; a pair spans the test frames between them."""
    w2c_all = full_video_w2c(motion_net, total_nb_images, nb_sample_timestep)
    i_train = torch.as_tensor(np.asarray(i_train), device=w2c_all.device)
    return w2c_all[i_train[1:]] @ se3_inverse(w2c_all[i_train[:-1]])
