"""Port parity for the data layer and the host metrics: scenes written by
either package's ``data/synthetic.py`` in the three conventions (Co3D,
Tanks & Temples, ScanNet) load through the port's and the JAX package's
``get_data_fields`` to the same arrays; ``colmap``, ``matrix_to_euler_angles``,
``compute_depth_errors``, ``pose_error_report`` and the reference-style
dataloader agree.

Tolerances: the data layer is numpy and cv2 in both packages, so images,
camera matrices, splits, reference tensors and the Tanks / ScanNet poses are
compared exactly. The Co3D poses pass through an Euler round trip in float32
(``jax.numpy`` there, ``torch`` here), whose arctan / arcsin / cos / sin may
differ in the last bit: 1e-6 absolute. The Euler angles themselves get 2e-6
(arctan2 near +-pi). The metrics are numpy copies: exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.data import colmap as JC
from copenerf_tpu.data import dataloading as JD
from copenerf_tpu.data import fields as JF
from copenerf_tpu.data import synthetic as JS
from copenerf_tpu.evaluation import metrics_pose as JM
from copenerf_tpu.poses import rotations as JR
from copenerf_tpu.training import depth_metrics as JDM
from copenerf_torch.config.loader import load_config
from copenerf_torch.data import colmap as TC
from copenerf_torch.data import dataloading as TD
from copenerf_torch.data import fields as TF
from copenerf_torch.data import synthetic as TS
from copenerf_torch.evaluation import metrics_pose as TM
from copenerf_torch.poses import rotations as TR
from copenerf_torch.training import depth_metrics as TDM

H, W = 30, 40
N_FRAMES = 10
WRITERS = {"co3d": "make_scene", "tanks": "make_scene_tanks",
           "scannet": "make_scene_scannet"}
# (convention, package that wrote the scene)
SCENES = [(c, p) for c in WRITERS for p in ("jax", "port")]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for conv, pkg in SCENES:
        root = str(tmp_path_factory.mktemp(f"{conv}_{pkg}"))
        mod = JS if pkg == "jax" else TS
        out[conv, pkg] = getattr(mod, WRITERS[conv])(root, n_frames=N_FRAMES,
                                                    h=H, w=W)
    return out


def _cfg(path, name, spherify=True):
    cfg = load_config(None)
    cfg["dataloading"].update({"path": path, "scene": [name],
                               "spherify": spherify})
    cfg["training"]["resolution"] = [H // 2, W // 2]
    return cfg


FIELD_ARRAYS = ("all_imgs", "imgs", "K", "c2ws", "c2ws_all", "i_train",
                "i_test", "idx_list", "gt_depths")


def _assert_fields_equal(got, ref, pose_atol):
    for k in FIELD_ARRAYS:
        g, r = np.asarray(getattr(got, k)), np.asarray(getattr(ref, k))
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k.startswith("c2ws"):
            np.testing.assert_allclose(g, r, rtol=0, atol=pose_atol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    for k in ("N_imgs", "N_imgs_train", "N_imgs_test", "total_nb_images",
              "focal", "img_list", "h", "w"):
        assert getattr(got, k) == getattr(ref, k), k
    for target in range(len(ref.all_imgs)):
        for g, r in zip(got.ref_tensors(target, 3), ref.ref_tensors(target, 3)):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("conv,pkg", SCENES)
def test_data_fields_match_jax(scenes, conv, pkg, mode):
    """Both packages' ``get_data_fields`` on the scene written by ``pkg``."""
    cfg = _cfg(*scenes[conv, pkg])
    got = TF.get_data_fields(cfg, mode)["img"]
    ref = JF.get_data_fields(cfg, mode)["img"]
    _assert_fields_equal(got, ref, 1e-6 if conv == "co3d" else 0.0)
    if conv != "tanks":
        assert len(ref.gt_depths) == N_FRAMES


def test_tanks_without_spherify_matches_jax(scenes):
    cfg = _cfg(*scenes["tanks", "port"], spherify=False)
    _assert_fields_equal(TF.get_data_fields(cfg)["img"],
                         JF.get_data_fields(cfg)["img"], 0.0)


@pytest.mark.parametrize("conv", sorted(WRITERS))
def test_port_writer_matches_jax_writer(scenes, conv):
    """The port's synthetic writer produces the JAX writer's files: the same
    JPEG bytes and the same arrays."""
    (jpath, name), (tpath, _) = scenes[conv, "jax"], scenes[conv, "port"]
    jdir, tdir = os.path.join(jpath, name), os.path.join(tpath, name)
    files = sorted(os.path.relpath(os.path.join(r, f), jdir)
                   for r, _, fs in os.walk(jdir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), tdir)
                           for r, _, fs in os.walk(tdir) for f in fs)
    for f in files:
        a, b = os.path.join(jdir, f), os.path.join(tdir, f)
        if f.endswith(".jpg"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        elif f.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                np.testing.assert_array_equal(x["pred"], y["pred"], err_msg=f)
        else:
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=f)


def test_dataloader_matches_jax(scenes):
    """The seeded reference-style loader: same view order, same items."""
    cfg = _cfg(*scenes["co3d", "port"])
    tl, _ = TD.get_dataloader(cfg, "train", shuffle=True, seed=3)
    jl, _ = JD.get_dataloader(cfg, "train", shuffle=True, seed=3)
    assert len(tl) == len(jl)
    for got, ref in zip(tl, jl):
        assert set(got) == set(ref)
        for k, r in ref.items():
            g = got[k]
            if k.endswith("c2ws") or k == "img.camera_mat":
                np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                           rtol=0, atol=1e-6, err_msg=k)
            elif isinstance(r, list):
                assert len(g) == len(r), k
                for a, b in zip(g, r):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b), err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                              err_msg=k)


# ---------------------------------------------------------------------------
# Rotations and COLMAP pose math
# ---------------------------------------------------------------------------

CONVENTIONS = ["XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",
               "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ"]


def _rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], 1).astype(np.float32)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_matrix_to_euler_angles_matches_jax(convention):
    r = _rotations(64, 1)
    got = TR.matrix_to_euler_angles(torch.from_numpy(r), convention).numpy()
    ref = np.asarray(JR.matrix_to_euler_angles(jnp.asarray(r), convention))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    back = TR.euler_angles_to_matrix(torch.from_numpy(got), convention).numpy()
    np.testing.assert_allclose(back, r, rtol=0, atol=2e-5)


def _llff_poses(n, seed):
    """(n, 3, 5) poses [c2w | hwf] on an arc, plus their bounds."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        ang = -0.4 + 0.8 * i / (n - 1)
        eye = np.array([2 * np.sin(ang), 0.3 * rng.normal(), -2 * np.cos(ang)])
        c2w = JS.look_at(eye, (0, 0, 0))[:3, :4]
        poses.append(np.concatenate([c2w, [[48.0], [64.0], [50.0]]], 1))
    bds = np.stack([rng.uniform(0.5, 1.0, n), rng.uniform(3, 4, n)], 1)
    return np.stack(poses), bds


def test_colmap_pose_math_matches_jax():
    poses, bds = _llff_poses(9, 2)
    np.testing.assert_array_equal(TC.poses_avg(poses), JC.poses_avg(poses))
    np.testing.assert_array_equal(TC.recenter_poses(poses),
                                  JC.recenter_poses(poses))
    for got, ref in zip(TC.spherify_poses(poses, bds),
                        JC.spherify_poses(poses, bds)):
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# Depth and pose metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clamp_pred", [False, True])
def test_compute_depth_errors_matches_jax(clamp_pred):
    """The prediction at half the GT's size (nearest resize inside), a GT
    with pixels outside [min_depth, max_depth]."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.5, 4.0, (24, 32)).astype(np.float32)
    gt[:3] = 0.0
    pred = (rng.uniform(0.8, 1.2, (12, 16)) * 2.0).astype(np.float32)
    got = TDM.compute_depth_errors(gt, pred, clamp_pred=clamp_pred)
    ref = JDM.compute_depth_errors(gt, pred, clamp_pred=clamp_pred)
    assert got == ref


def test_pose_error_report_matches_jax():
    """A GT arc and a scaled, rotated, noisy copy of it."""
    gt = np.stack([JS.look_at([2 * np.sin(a), 0.1 * a, -2 * np.cos(a)],
                              (0, 0, 0)) for a in np.linspace(-0.4, 0.4, 9)])
    rng = np.random.default_rng(4)
    pred = gt.copy()
    pred[:, :3, 3] = 0.7 * pred[:, :3, 3] + rng.normal(size=(9, 3)) * 0.02
    pred[:, :3, :3] = _rotations(1, 5)[0].astype(np.float64) @ pred[:, :3, :3]
    got = TM.pose_error_report(pred, gt)
    ref = JM.pose_error_report(pred, gt)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    assert np.isfinite(got[1:]).all()
