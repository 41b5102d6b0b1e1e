"""COLMAP pose utilities for Tanks-and-Temples-style scenes (port copy of
``copenerf_tpu/data/colmap.py``, numpy and cv2 as there).

``poses_avg`` / ``recenter_poses`` / ``spherify_poses`` are the
convention-defining math of the LLFF ``poses_bounds.npy`` format (from
bmild/LLFF ``llff/poses/pose_utils.py``, vendored by NoPe-NeRF and
CoPE-NeRF): a loader of this format must reproduce these formulas exactly or
the recovered camera frames disagree with every published checkpoint. Images
are read and minified with cv2 in-process.
"""

from __future__ import annotations

import os

import numpy as np


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def spherify_poses(poses, bds):
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]),
                        [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        return np.squeeze(-np.linalg.inv(
            (np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ b_i.mean(0))

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(
        poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses,
         np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1)
    return poses_reset, new_poses, bds


IMG_EXTS = (".JPG", ".jpg", ".png", ".jpeg", ".PNG")


def list_images(imgdir: str):
    return [f for f in sorted(os.listdir(imgdir)) if f.endswith(IMG_EXTS)]


def load_scene_images(basedir: str, factor=None, crop_size: int = 0):
    """Load images (+ optional crop and downscale-by-factor), returning
    (imgs (N, H, W, 3) float in [0, 1], names, crop_ratio, focal_crop_factor).

    Crop semantics match the reference loader: crop ``crop_size`` rows
    (and the aspect-scaled columns) from each border, then resize back to the
    original size; ``focal_crop_factor = (H - 2*crop)/H`` rescales focals.
    """
    import cv2

    imgdir = os.path.join(basedir, "images")
    names = list_images(imgdir)
    imgs = []
    crop_ratio = 1.0
    focal_crop_factor = 1.0
    for f in names:
        img = cv2.cvtColor(cv2.imread(os.path.join(imgdir, f),
                                      cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        if crop_size != 0:
            ch = crop_size
            cw = int(ch * w / h)
            cropped = img[ch:h - ch, cw:w - cw]
            img = cv2.resize(cropped, (w, h), interpolation=cv2.INTER_AREA)
            crop_ratio = ch / h
            focal_crop_factor = (h - 2 * ch) / h
        if factor is not None and factor != 1:
            img = cv2.resize(img, (int(w / factor), int(h / factor)),
                             interpolation=cv2.INTER_AREA)
        imgs.append(img.astype(np.float32) / 255.0)
    return np.stack(imgs), names, crop_ratio, focal_crop_factor


def load_poses_bounds(basedir: str, n_images: int, image_hw=None, factor=None):
    """Unpack poses_bounds.npy -> (poses (3, 5, N), bds (2, N)): the hwf
    column gets the loaded image shape and the focal rescaled by 1/factor
    (as the reference loader does)."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = arr[:, -2:].transpose([1, 0])
    if poses.shape[-1] != n_images:
        raise ValueError(
            f"poses_bounds has {poses.shape[-1]} entries, {n_images} images")
    if image_hw is not None:
        poses[:2, 4, :] = np.array(image_hw).reshape([2, 1])
    if factor:
        poses[2, 4, :] = poses[2, 4, :] / factor
    return poses, bds
