"""Trajectory metrics: Sim(3) Umeyama alignment, ATE-RMSE, RPE (port copy
of ``copenerf_tpu/evaluation/metrics_pose.py``).

Numpy re-implementations with the same protocol as the reference:
  * ``align_umeyama`` — ``ATE/align_trajectory.py:28-80``;
  * ``align_ate_c2b_use_a2b`` — ``utils_poses/align_traj.py:26-69`` (align
    pred to GT with the sim3 fitted on translations);
  * ``compute_ATE`` / ``compute_rpe`` — ``utils_poses/comp_ate.py:33-73``;
  * call-site scaling: RPE-trans x100, RPE-rot in degrees
    (``train.py:169-178``).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(model: np.ndarray, data: np.ndarray, known_scale=False):
    """Least-squares s, R, t with model ~= s * R @ data + t."""
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    model_zc = model - mu_m
    data_zc = data - mu_d
    n = model.shape[0]

    c = (1.0 / n) * (model_zc.T @ data_zc)
    sigma2 = (1.0 / n) * np.sum(data_zc * data_zc)
    u, d, vt = np.linalg.svd(c)
    d = np.diag(d)
    v = vt.T
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(v) < 0:
        s_mat[2, 2] = -1
    rot = u @ s_mat @ v.T
    scale = 1.0 if known_scale else (1.0 / sigma2) * np.trace(d @ s_mat)
    t = mu_m - scale * (rot @ mu_d)
    return scale, rot, t


def align_ate_c2b_use_a2b(traj_a: np.ndarray, traj_b: np.ndarray,
                          traj_c=None) -> np.ndarray:
    """Align trajectory c to b using the Sim(3) fitted from a to b."""
    if traj_c is None:
        traj_c = traj_a.copy()
    t_a = traj_a[:, :3, 3]
    t_b = traj_b[:, :3, 3]
    s, rot, t = align_umeyama(t_b, t_a)  # b ~= s R a + t

    r_c = traj_c[:, :3, :3]
    t_c = traj_c[:, :3, 3:4]
    r_aligned = rot[None] @ r_c
    t_aligned = s * (rot[None] @ t_c) + t.reshape(1, 3, 1)
    out = np.broadcast_to(np.eye(4), (len(traj_c), 4, 4)).copy()
    out[:, :3, :3] = r_aligned
    out[:, :3, 3:] = t_aligned
    return out.astype(np.float32)


def rotation_error(pose_error: np.ndarray) -> float:
    a, b, c = pose_error[0, 0], pose_error[1, 1], pose_error[2, 2]
    d = 0.5 * (a + b + c - 1.0)
    return float(np.arccos(max(min(d, 1.0), -1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def compute_rpe(gt: np.ndarray, pred: np.ndarray):
    """Mean consecutive-frame relative-pose errors (trans, rot in radians)."""
    trans_errors, rot_errors = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pred_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel_err = np.linalg.inv(gt_rel) @ pred_rel
        trans_errors.append(translation_error(rel_err))
        rot_errors.append(rotation_error(rel_err))
    return float(np.mean(trans_errors)), float(np.mean(rot_errors))


def compute_ate(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of translation differences."""
    err = gt[:, :3, 3] - pred[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1))))


def pose_error_report(pred_poses: np.ndarray, gt_poses: np.ndarray):
    """Full protocol of the reference's ``compute_pose_error``
    (train.py:169-178): Sim(3)-align pred to GT, then ATE + scaled RPE.

    Returns (aligned_pred (N,4,4), rpe_trans*100, rpe_rot_deg, ate).
    """
    aligned = align_ate_c2b_use_a2b(pred_poses, gt_poses)
    ate = compute_ate(gt_poses, aligned)
    rpe_t, rpe_r = compute_rpe(gt_poses, aligned)
    return aligned, rpe_t * 100.0, np.degrees(rpe_r), ate
