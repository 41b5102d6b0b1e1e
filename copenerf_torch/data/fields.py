"""Dataset loading for the three supported scene conventions (port of
``copenerf_tpu/data/fields.py``; numpy on the host, as there):

  * Tanks & Temples: COLMAP ``poses_bounds.npy`` -> axis swap, bd rescale
    (factor 0.75), recenter, optional spherify.
  * ScanNet: ``intrinsic.npy`` + ``pose.npy`` with the (1,-1,-1,1) axis flip.
  * Co3D: per-frame ``intrinsic.npy``; ``pose.npy`` inverted, translation
    normalized CF3DGS-style over the train split, Y-axis euler/translation
    flip (the euler round trip in float32 through ``poses/rotations.py``).

Train/test split: ``i_test = ids[sample_rate//2::sample_rate]``. The
NDC-style per-frame camera matrix is
``[[2fx/W, 0, 0, 0], [0, -2fy/H, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]]`` built
from pre-resize dimensions.
"""

from __future__ import annotations

import os

import numpy as np

from .colmap import (list_images, load_poses_bounds, load_scene_images,
                     recenter_poses, spherify_poses)


def _resize_nearest(imgs: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, C, H0, W0) -> (N, C, h, w), nearest (matches the reference's
    default-mode ``F.interpolate``, dataset.py:98)."""
    n, c, h0, w0 = imgs.shape
    row_idx = (np.arange(h) * (h0 / h)).astype(np.int64)
    col_idx = (np.arange(w) * (w0 / w)).astype(np.int64)
    return imgs[:, :, row_idx][:, :, :, col_idx]


def _ndc_camera_mat(fx, fy, w, h) -> np.ndarray:
    return np.array([[2 * fx / w, 0, 0, 0],
                     [0, -2 * fy / h, 0, 0],
                     [0, 0, -1, 0],
                     [0, 0, 0, 1]], np.float32)


def _co3d_pose_preprocess(poses: np.ndarray, i_train: np.ndarray):
    """Invert, normalize translation over the train split, flip the Y axis
    (the vendored PyTorch3D euler conversions, in float32)."""
    import torch

    from ..poses.rotations import (euler_angles_to_matrix,
                                   matrix_to_euler_angles)

    c2ws = np.linalg.inv(poses).astype(np.float32)
    gt_r = c2ws[:, :3, :3].copy()
    gt_t = c2ws[:, :3, -1].copy()
    gt_t = gt_t - gt_t[i_train].mean(axis=0)
    gt_t = gt_t / np.linalg.norm(gt_t[i_train])
    euler = matrix_to_euler_angles(torch.from_numpy(gt_r), "XYZ").numpy()
    euler[:, 1:] *= -1
    gt_r = euler_angles_to_matrix(torch.from_numpy(euler), "XYZ").numpy()
    gt_t[:, 1:] *= -1
    out = np.broadcast_to(np.eye(4, dtype=np.float32),
                          (len(gt_r), 4, 4)).copy()
    out[:, :3, :3] = gt_r
    out[:, :3, -1] = gt_t
    return out


class DataField:
    """Holds a scene fully in host RAM as numpy arrays.

    Public attributes (names follow the reference for drop-in use):
      imgs            (N_mode, 3, h, w) selected-split images
      all_imgs        (N_total, 3, h, w) all frames (test frames zeroed in
                      train mode, reference :191-192)
      idx_list, i_train, i_test, N_imgs, N_imgs_train, N_imgs_test
      c2ws            (N_mode, 4, 4) GT camera-to-world poses
      K               (N_total, 4, 4) per-frame NDC-style camera matrices
      gt_depths       (N_total, H, W) or []
      total_nb_images number of frames in the video
    """

    def __init__(self, model_path, scene_name=(" ",), mode="train",
                 spherify=False, load_ref_img=True, resize_factor=None,
                 crop_size=0, random_ref_interval=(1, 2, 3),
                 load_gt_depth=True, load_colmap_poses=True, sample_rate=8,
                 resolution=None, **kwargs):
        self.mode = mode
        self.random_ref_interval = list(random_ref_interval)
        self.ref_img = load_ref_img
        self.sample_rate = sample_rate
        self.h, self.w = resolution[0], resolution[1]

        is_tank = ("tanks" in model_path.lower())
        is_scannet = ("scannet" in model_path.lower())
        is_co3d = ("co3d" in model_path.lower())
        load_colmap_poses = is_tank
        load_dir = os.path.join(model_path, scene_name[0])

        imgs_hw3, img_names, crop_ratio, focal_crop_factor = \
            load_scene_images(load_dir, factor=resize_factor,
                              crop_size=crop_size)
        self.img_names_all = img_names
        n_total = len(imgs_hw3)
        original_h, original_w = imgs_hw3.shape[1:3]

        c2ws_gt = None
        focal = None
        if is_tank:
            poses, bds = load_poses_bounds(
                load_dir, n_total, image_hw=(original_h, original_w),
                factor=resize_factor)
            poses = np.concatenate(
                [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
            poses = np.moveaxis(poses, -1, 0).astype(np.float32)
            bds = np.moveaxis(bds, -1, 0).astype(np.float32)
            sc = 1.0 / (bds.min() * 0.75)
            poses[:, :3, 3] *= sc
            bds *= sc
            poses = recenter_poses(poses)
            if spherify:
                poses, _, bds = spherify_poses(poses, bds)
            input_poses = poses.astype(np.float32)
            self.hwf = input_poses[:, :3, :]
            focal = input_poses[0, :3, -1][2]
            bottom = np.tile(np.array([[0, 0, 0, 1]], np.float32),
                             (n_total, 1, 1))
            c2ws_gt = np.concatenate([input_poses[:, :3, :4], bottom], 1)

        imgs = np.transpose(imgs_hw3, (0, 3, 1, 2)).astype(np.float32)
        imgs = _resize_nearest(imgs, self.h, self.w)

        # Camera intrinsics -> per-frame NDC-style K.
        if is_tank:
            fx = fy = focal / focal_crop_factor
            self.K = np.stack([_ndc_camera_mat(fx, fy, original_w, original_h)
                               for _ in range(n_total)])
            self.focal = fx
        elif is_scannet:
            intr = np.load(os.path.join(load_dir, "intrinsic.npy"))
            fx = intr[0, 0] / focal_crop_factor
            fy = intr[1, 1] / focal_crop_factor
            self.K = np.stack([_ndc_camera_mat(fx, fy, original_w, original_h)
                               for _ in range(n_total)])
            self.focal = fx
        elif is_co3d:
            intr_list = np.load(os.path.join(load_dir, "intrinsic.npy"))
            ks = []
            for intr in intr_list:
                fx = intr[0, 0] / focal_crop_factor
                fy = intr[1, 1] / focal_crop_factor
                ks.append(_ndc_camera_mat(fx, fy, original_w, original_h))
            self.K = np.stack(ks)
            self.focal = fx
        else:
            raise ValueError(
                f"cannot infer dataset convention from path {model_path!r} "
                "(expected 'tanks', 'scannet' or 'co3d' in the path)")
        self.H, self.W = self.h, self.w

        ids = np.arange(n_total)
        i_test = ids[int(sample_rate / 2)::sample_rate]
        i_train = np.array([i for i in ids if i not in i_test])
        self.i_train, self.i_test = i_train, i_test

        if is_scannet:
            poses = np.load(os.path.join(load_dir, "pose.npy"))
            flip = np.diag([1, -1, -1, 1]).astype(np.float32)
            c2ws_gt = (poses @ flip).astype(np.float32)
        elif is_co3d:
            poses = np.load(os.path.join(load_dir, "pose.npy"))
            c2ws_gt = _co3d_pose_preprocess(poses, i_train)

        self.N_imgs_train = len(i_train)
        self.N_imgs_test = len(i_test)

        if mode in ("train", "eval_trained", "render"):
            idx_list = i_train
        elif mode == "eval":
            idx_list = i_test
        else:  # 'all'
            idx_list = ids
        self.idx_list = idx_list
        self.img_list = [img_names[i] for i in idx_list]

        self.all_imgs = imgs
        if mode in ("train", "eval_trained", "render"):
            self.all_imgs = imgs.copy()
            self.all_imgs[i_test] = 0.0
        self.imgs = imgs[idx_list]
        self.N_imgs = len(idx_list)
        self.c2ws = c2ws_gt[idx_list]
        self.c2ws_all = c2ws_gt

        self.gt_depths = []
        if load_gt_depth and (is_scannet or is_co3d):
            depth_dir = os.path.join(load_dir, "gt_depth")
            if os.path.isdir(depth_dir):
                self.gt_depths = np.stack(
                    [np.load(os.path.join(
                        depth_dir, f"depth_{str(i).zfill(6)}.npz"))["pred"]
                     for i in range(n_total)])

        # Frame count for time normalization (reference train.py:67 counts
        # jpgs in the images dir).
        jpgs = [f for f in list_images(os.path.join(load_dir, "images"))
                if f.lower().endswith((".jpg", ".jpeg"))]
        self.total_nb_images = len(jpgs) if jpgs else n_total

    # -- reference-compatible per-item API ---------------------------------

    def load(self, idx: int) -> dict:
        """Return the reference's per-item dict (dataset.py:215-316)."""
        target = int(self.idx_list[idx])
        data = {
            None: self.imgs[idx],
            "idx": target,
            "scale_mat": np.eye(4, dtype=np.float32),
            "camera_mat": self.K[target],
        }
        ref_image_list, ref_idxs, ref_k = [], [], []
        for interval in self.random_ref_interval:
            ref_idx = target + interval
            if ref_idx in self.i_test:
                continue
            if ref_idx >= len(self.all_imgs):
                ref_image_list.append(
                    np.ones_like(self.all_imgs[0]) * 10e5)
                ref_k.append(np.ones_like(self.K[0]) * 10e5)
            else:
                ref_image_list.append(self.all_imgs[ref_idx])
                ref_k.append(self.K[ref_idx])
            ref_idxs.append(ref_idx)
        data["ref_image_list"] = ref_image_list
        data["ref_idxs"] = ref_idxs
        data["ref_camera_mat"] = ref_k
        return data

    def ref_tensors(self, target_idx: int, n_ref: int):
        """Fixed-shape masked ref tensors for the jitted train step.

        Returns (ref_images (n_ref, 3, h, w), ref_idxs (n_ref,),
        in_list (n_ref,), valid_flow (n_ref,), ref_K (n_ref, 4, 4)).
        ``in_list`` mirrors membership in the reference's variable-length ref
        list (skips i_test refs); ``valid_flow`` additionally requires the ref
        frame to exist (time step <= 1).
        """
        n_total = len(self.all_imgs)
        imgs = np.zeros((n_ref, 3, self.h, self.w), np.float32)
        idxs = np.zeros((n_ref,), np.int32)
        in_list = np.zeros((n_ref,), np.float32)
        valid = np.zeros((n_ref,), np.float32)
        ref_k = np.stack([np.eye(4, dtype=np.float32)] * n_ref)
        for t, interval in enumerate(self.random_ref_interval[:n_ref]):
            ref_idx = target_idx + interval
            idxs[t] = min(ref_idx, n_total - 1)
            if ref_idx in self.i_test:
                continue
            in_list[t] = 1.0
            if ref_idx < n_total:
                valid[t] = 1.0
                imgs[t] = self.all_imgs[ref_idx]
                ref_k[t] = self.K[ref_idx]
        return imgs, idxs, in_list, valid, ref_k


def get_data_fields(cfg: dict, mode: str = "train") -> dict:
    """Reference ``get_data_fields`` (dataloading.py:54-93)."""
    d = cfg["dataloading"]
    load_ref_img = (cfg["training"]["flow_rgb_weight"] != 0.0)
    field = DataField(
        model_path=d["path"], scene_name=d["scene"], mode=mode,
        spherify=d["spherify"], load_ref_img=load_ref_img,
        resize_factor=d["resize_factor"], crop_size=d["crop_size"],
        random_ref_interval=d["random_ref_interval"],
        load_gt_depth=d["load_gt_depth"],
        load_colmap_poses=d["load_colmap_poses"],
        sample_rate=d["sample_rate"],
        resolution=cfg["training"]["resolution"])
    return {"img": field}
