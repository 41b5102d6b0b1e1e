"""Synthetic scene fabrication in all three dataset conventions (port copy
of ``copenerf_tpu/data/synthetic.py``, numpy and cv2 as there).

Renders an analytic lambertian sphere from a smoothly moving camera and
writes the on-disk layouts the data layer expects:

  * ``make_scene``          — Co3D: ``images/*.jpg``, per-frame
    ``intrinsic.npy``, ``pose.npy`` (world-to-camera, as Co3D stores it),
    ``gt_depth/depth_%06d.npz``;
  * ``make_scene_tanks``    — Tanks & Temples: ``poses_bounds.npy`` in the
    COLMAP/LLFF packing;
  * ``make_scene_scannet``  — ScanNet: shared ``intrinsic.npy`` + ``pose.npy``
    with the (1,-1,-1,1) axis-flip storage convention, plus GT depth so
    ``depth_eval`` runs.

The tests and ``chip_smoke.py`` train the port on these scenes.
"""

import os

import numpy as np


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def render_sphere(c2w, h, w, fx, fy, radius=0.5, center=(0, 0, 0)):
    """Ray-trace a diffuse sphere; returns (rgb (h, w, 3), depth (h, w))."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs_cam = np.stack([(xs - w / 2) / fx, (ys - h / 2) / fy,
                         np.ones_like(xs, np.float64)], -1)
    rd = dirs_cam @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = c2w[:3, 3]
    oc = ro - np.asarray(center, np.float64)
    b = np.sum(rd * oc, -1)
    c = np.sum(oc * oc) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    pts = ro + rd * t[..., None]
    normal = (pts - center) / radius
    light = np.array([0.5, -0.8, 0.3])
    light = light / np.linalg.norm(light)
    lam = np.clip(np.sum(normal * light, -1), 0, 1)
    albedo = 0.5 + 0.5 * np.stack(
        [np.sin(3 * pts[..., 0]), np.cos(3 * pts[..., 1]),
         np.sin(2 * pts[..., 2])], -1)
    rgb = np.where(hit[..., None], albedo * (0.3 + 0.7 * lam[..., None]),
                   0.12 + 0.75 * np.stack([xs / w, ys / h,
                                           0.5 * np.ones_like(xs)], -1))
    depth = np.where(hit, t, 4.0)
    return np.clip(rgb, 0, 1), depth


def _arc_c2w(i, n_frames):
    """Smooth look-at arc around the origin (shared by all conventions)."""
    ang = -0.35 + 0.7 * i / max(n_frames - 1, 1)
    eye = np.array([1.8 * np.sin(ang), 0.25 * np.sin(2 * ang),
                    -1.8 * np.cos(ang)])
    return look_at(eye, (0, 0, 0))


def _write_frames(scene_dir, n_frames, h, w, fx, fy, write_depth):
    """Render + write jpgs (and optional z-depth npz); return c2w list."""
    import cv2

    os.makedirs(os.path.join(scene_dir, "images"), exist_ok=True)
    if write_depth:
        os.makedirs(os.path.join(scene_dir, "gt_depth"), exist_ok=True)
    c2ws = []
    for i in range(n_frames):
        c2w = _arc_c2w(i, n_frames)
        rgb, depth = render_sphere(c2w, h, w, fx, fy)
        img8 = (rgb * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(scene_dir, "images", f"frame_{i:04d}.jpg"),
                    cv2.cvtColor(img8, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 97])
        if write_depth:
            # Distance-along-ray -> z-depth (what the eval renderer emits).
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            norm = np.sqrt(((xs - w / 2) / fx) ** 2 +
                           ((ys - h / 2) / fy) ** 2 + 1.0)
            np.savez(os.path.join(scene_dir, "gt_depth",
                                  f"depth_{str(i).zfill(6)}.npz"),
                     pred=(depth / norm).astype(np.float32))
        c2ws.append(c2w)
    return c2ws


def make_scene_tanks(root, n_frames=10, h=48, w=64, focal=70.0):
    """Create ``<root>/tanks_synth/scene0`` in the Tanks & Temples layout:
    ``poses_bounds.npy`` packs per-frame (3, 5) [LLFF-swapped c2w | hwf]
    rows + [near, far]. The stored pose inverts the loader's axis swap
    (``[p1, -p0, p2]``, reference dataset.py:76-78) so the loaded result —
    up to the recenter/spherify Sim(3) the ATE alignment absorbs — is the
    rendering camera. Returns (path, scene_name)."""
    base = os.path.join(root, "tanks_synth")
    scene_dir = os.path.join(base, "scene0")
    c2ws = _write_frames(scene_dir, n_frames, h, w, focal, focal,
                         write_depth=False)
    rows = []
    for c2w in c2ws:
        p = c2w[:3, :4]
        stored = np.stack([-p[:, 1], p[:, 0], p[:, 2], p[:, 3]], axis=1)
        hwf = np.array([[h], [w], [focal]], np.float64)
        near = 1.8 - 0.5 - 0.1   # camera orbit radius minus sphere radius
        far = 1.8 + 0.5 + 1.5
        rows.append(np.concatenate([np.concatenate([stored, hwf], 1)
                                    .reshape(-1), [near, far]]))
    np.save(os.path.join(scene_dir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
    return base, "scene0"


def make_scene_scannet(root, n_frames=10, h=48, w=64, fx=70.0, fy=70.0,
                       write_depth=True):
    """Create ``<root>/scannet_synth/scene0`` in the ScanNet layout: one
    shared ``intrinsic.npy``, ``pose.npy`` storing ``c2w @ diag(1,-1,-1,1)``
    (the loader applies the same involutive flip back, reference
    dataset.py:150-154), and GT z-depth so ``depth_eval`` runs.
    Returns (path, scene_name)."""
    base = os.path.join(root, "scannet_synth")
    scene_dir = os.path.join(base, "scene0")
    c2ws = _write_frames(scene_dir, n_frames, h, w, fx, fy, write_depth)
    intr = np.eye(4)
    intr[0, 0], intr[1, 1] = fx, fy
    intr[0, 2], intr[1, 2] = w / 2, h / 2
    np.save(os.path.join(scene_dir, "intrinsic.npy"), intr)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    np.save(os.path.join(scene_dir, "pose.npy"),
            np.stack([c2w @ flip for c2w in c2ws]).astype(np.float32))
    return base, "scene0"


def make_scene(root, n_frames=12, h=60, w=80, write_depth=True):
    """Create ``<root>/co3d_synth/scene0`` and return (path, scene_name)."""
    import cv2

    base = os.path.join(root, "co3d_synth")
    scene_dir = os.path.join(base, "scene0")
    os.makedirs(os.path.join(scene_dir, "images"), exist_ok=True)
    if write_depth:
        os.makedirs(os.path.join(scene_dir, "gt_depth"), exist_ok=True)

    fx = fy = 70.0
    intr = np.eye(3)
    intr[0, 0], intr[1, 1] = fx, fy
    intr[0, 2], intr[1, 2] = w / 2, h / 2

    poses_w2c = []
    intr_list = []
    for i in range(n_frames):
        ang = -0.35 + 0.7 * i / max(n_frames - 1, 1)
        eye = np.array([1.8 * np.sin(ang), 0.25 * np.sin(2 * ang),
                        -1.8 * np.cos(ang)])
        c2w = look_at(eye, (0, 0, 0))
        rgb, depth = render_sphere(c2w, h, w, fx, fy)
        img8 = (rgb * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(scene_dir, "images", f"frame_{i:04d}.jpg"),
                    cv2.cvtColor(img8, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 97])
        if write_depth:
            np.savez(os.path.join(scene_dir, "gt_depth",
                                  f"depth_{str(i).zfill(6)}.npz"),
                     pred=depth.astype(np.float32))
        poses_w2c.append(np.linalg.inv(c2w))
        intr_list.append(intr)

    np.save(os.path.join(scene_dir, "pose.npy"),
            np.stack(poses_w2c).astype(np.float32))
    np.save(os.path.join(scene_dir, "intrinsic.npy"),
            np.stack(intr_list).astype(np.float32))
    return base, "scene0"
