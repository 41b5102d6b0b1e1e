"""Port parity for the ``Evaluator``: the port's ``evaluation/evaluator.py``
against the JAX package's on the CPU, on one Co3D-convention synthetic scene
(10 frames at 24x32, sample rate 4: test frames 2 and 6, 8 train views) at
the small widths of ``test_torch_trainer.py``.

Neither package trains: one JAX initial state is written as a checkpoint
past ``start_query_world_epoch``, beside one ``refine_pose.npz`` (the
scene's relative train poses, re-anchored on the world camera and perturbed
by a seeded rotation and shift). Both ``Evaluator``s read them and run 3
epochs of test-time pose optimization with the same injected rays and
jitter (``eval_inject_streams``, drawn from numpy by iteration). The JAX
side takes its plain XLA path on the CPU, at HIGHEST matmul precision.

Tolerances, f32 on both sides (measured gaps in brackets):
  * the lr trace, exactly (the same host schedule);
  * the l2 trace, L2_RTOL relative [1.2e-7], and the optimized ``r``,
    ``t``, POSE_ATOL absolute [1.4e-8]. The refinement tests' bound (1e-4) is
    the ceiling: Adam's first steps move each entry by about lr sign(g)
    (lr 1.25e-4 here), so an entry whose gradient sign differed between
    the packages would move them up to 2.5e-4 apart; here every entry's
    gradient is far from zero, and the gradients agree to ~1e-7 of
    themselves, so the poses agree to 1e-8;
  * each package reading the other's ``model_eval_pose.npz``: exactly;
  * PSNR, SSIM and the 7 depth metrics of ``eval``: METRIC_RTOL relative
    [PSNR 2.8e-6, SSIM 1.0e-6, depth 1.4e-7]: the renders of poses 1e-8
    apart through each package's f32 field and compositing;
  * ATE and RPE of the train poses: 1e-5 absolute [2.7e-8] (both read
    refine_pose.npz).

The field weights are bit-identical before and after the optimization and
take no gradient.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from copenerf_tpu.data.fields import get_data_fields as j_data_fields
from copenerf_tpu.data.synthetic import make_scene
from copenerf_tpu.evaluation import evaluator as JE
from copenerf_tpu.models import fields as JF
from copenerf_tpu.training import checkpoints as JCK
from copenerf_tpu.training import step as JS
from copenerf_torch.evaluation import evaluator as TE
from copenerf_torch.poses.lie import make_c2w
from test_torch_trainer import N_SAMPLES, tiny_cfg

H, W = 24, 32
N_FRAMES = 10
EPOCHS = 3
N_POINTS = 64
L2_RTOL = 1e-5
POSE_ATOL = 1e-6
METRIC_RTOL = 1e-5


def eval_cfg(scene, out_dir):
    cfg = tiny_cfg(scene, out_dir, start_query_world_epoch=1,
                   n_training_points=N_POINTS)
    cfg["dataloading"]["sample_rate"] = 4
    cfg["eval"].update({"eval_pose_epoch": EPOCHS, "eval_pose_lr": 2.5e-4,
                        "eval_pose_scheduler_gamma": 0.5})
    return cfg


def streams(n):
    """Each pose step's rays and jitter, from numpy by iteration."""
    out = []
    for it in range(1, n + 1):
        rng = np.random.default_rng(2000 + it)
        out.append((rng.choice(H * W, N_POINTS, replace=False).astype(np.int32),
                    rng.uniform(size=(N_POINTS, N_SAMPLES)).astype(np.float32)))
    return out


def write_run(scene, out_dir):
    """The JAX initial state as a checkpoint at epoch 2 (past the
    transition at 1), and refine_pose.npz: the train views' ground-truth
    poses relative to the world camera, each rotated about a seeded axis
    by ~0.03 rad and shifted by ~0.01."""
    cfg = eval_cfg(scene, out_dir)
    params = JF.init_all_fields(jax.random.PRNGKey(0),
                                JF.configs_from_cfg(cfg))
    JCK.save_checkpoint(out_dir, JS.init_train_state(params),
                        {"epoch_it": 2, "it": 23, "depth_range": [0.5, 3.5]})
    field = j_data_fields(cfg, "train")["img"]
    c2w = field.c2ws.astype(np.float64)
    i_train = list(field.i_train)
    world = i_train.index(N_FRAMES // 2)
    rel = np.linalg.inv(c2w) @ c2w[world][None]
    rng = np.random.default_rng(7)
    r = rng.normal(scale=0.03, size=(len(i_train), 3))
    t = rng.normal(scale=0.01, size=(len(i_train), 3))
    r[world] = t[world] = 0.0
    noise = make_c2w(torch.from_numpy(r), torch.from_numpy(t)).numpy()
    poses = (noise @ rel).astype(np.float32)
    poses[world] = np.eye(4, dtype=np.float32)
    JCK.save_pytree(os.path.join(out_dir, "models", "refine_pose.npz"),
                    {"init_c2w": poses})
    return cfg


def fork(src, dst, cache=True):
    shutil.copytree(src, dst)
    if not cache:
        os.remove(os.path.join(dst, "models", "weights",
                               "model_eval_pose.npz"))
    return dst


def field_params(ev):
    return {k: v.detach().clone()
            for k, v in ev.state["fields"].named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' evaluators on copies of one run directory, built and
    run one at a time (each construction seeds ``np.random``); no LPIPS
    pack is reachable (HOME is a scratch folder, the env vars unset)."""
    root = tmp_path_factory.mktemp("eval")
    scene = make_scene(str(root / "scene"), n_frames=N_FRAMES, h=H, w=W)
    base = str(root / "base")
    write_run(scene, base)
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(root / "home"))
    mp.delenv("COPENERF_LPIPS_VGG", raising=False)
    mp.delenv("COPENERF_LPIPS_LIN", raising=False)
    r = {"scene": scene, "root": root, "base": base}
    try:
        jdir = fork(base, str(root / "jax"))
        je = JE.Evaluator(eval_cfg(scene, jdir), verbose=False)
        je.eval_inject_streams = streams(EPOCHS * 2)
        r["jax"], r["jax_result"] = je, je.eval()

        pdir = fork(base, str(root / "port"))
        pe = TE.Evaluator(eval_cfg(scene, pdir), device="cpu", verbose=False)
        pe.eval_inject_streams = streams(EPOCHS * 2)
        r["before"] = field_params(pe)
        with pytest.warns(UserWarning, match="LPIPS unavailable"):
            r["port_result"] = pe.eval()
        r["port"] = pe

        # Each package reads the other's cache; the port reuses its own.
        pj = TE.Evaluator(eval_cfg(scene, fork(jdir, str(root / "pj"))),
                          device="cpu", verbose=False)
        pj.eval_optimization()
        r["port_reads_jax"] = pj
        jp = JE.Evaluator(eval_cfg(scene, fork(pdir, str(root / "jp"))),
                          verbose=False)
        jp.eval_optimization()
        r["jax_reads_port"] = jp
        again = TE.Evaluator(eval_cfg(scene, pdir), device="cpu",
                             verbose=False)
        with pytest.warns(UserWarning, match="LPIPS unavailable"):
            r["again_result"] = again.eval(store_output=False)
        r["again"] = again
    finally:
        mp.undo()
    return r


def test_split_and_train_poses(runs):
    pe, je = runs["port"], runs["jax"]
    assert list(pe.test_field.i_test) == [2, 6]
    assert list(pe.train_field.i_train) == list(je.train_field.i_train)
    np.testing.assert_array_equal(
        pe.refined_c2w, np.asarray(JE.pose_retriever_all(*je.pose_retriever)))


def test_pose_optimization_matches_jax(runs):
    """3 epochs over 2 test views: the lr trace exactly (milestone 0 fires
    at epoch 0), the l2 trace and the optimized r, t within their bounds,
    and the initial poses exactly."""
    pe, je = runs["port"], runs["jax"]
    assert pe.eval_lr_trace == je.eval_lr_trace == [1.25e-4, 6.25e-5, 3.125e-5]
    assert pe.eval_l2_trace.shape == (EPOCHS * 2,)
    np.testing.assert_allclose(pe.eval_l2_trace, je.eval_l2_trace,
                               rtol=L2_RTOL, atol=0)
    (pp, pinit), (jp, jinit) = pe.pose_retriever_test, je.pose_retriever_test
    np.testing.assert_array_equal(pinit.numpy(), np.asarray(jinit))
    for k in ("r", "t"):
        got, ref = pp[k].numpy(), np.asarray(jp[k])
        np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_ATOL,
                                   err_msg=k)
        # Every entry moved (Adam moves the unsampled view through its
        # moments too), by about lr per step.
        assert np.all(np.abs(got) > 1e-5), (k, got)


def test_field_weights_frozen(runs):
    pe = runs["port"]
    for k, v in pe.state["fields"].named_parameters():
        assert torch.equal(v, runs["before"][k]), k
        assert v.grad is None, k
        assert v.requires_grad, k


def test_caches_cross_read(runs):
    """``model_eval_pose.npz`` in the JAX layout: each package reads the
    other's, and the port's second Evaluator reuses its own (no steps)."""
    for reader, writer in (("port_reads_jax", "jax"),
                           ("jax_reads_port", "port")):
        (rp, rinit) = runs[reader].pose_retriever_test
        (wp, winit) = runs[writer].pose_retriever_test
        for k in ("r", "t"):
            np.testing.assert_array_equal(np.asarray(rp[k]), np.asarray(wp[k]))
        np.testing.assert_array_equal(np.asarray(rinit), np.asarray(winit))
    assert runs["port_reads_jax"].eval_l2_trace is None
    assert runs["again"].eval_l2_trace is None


def test_metrics_match_jax(runs):
    got, ref = runs["port_result"], runs["jax_result"]
    assert set(got) == set(ref)
    names = ["PSNR", "SSIM", *TE.DEPTH_METRICS]
    for k in names:
        np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    for k in ("ate", "rpe_trans", "rpe_rot"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert np.isnan(got["LPIPS"]) and np.isnan(ref["LPIPS"])
    assert -1 <= got["SSIM"] <= 1 and np.isfinite(got["PSNR"])
    again = runs["again_result"]
    for k in names + ["ate", "rpe_trans", "rpe_rot"]:
        assert again[k] == got[k], k


def test_eval_writes_results_and_extraction(runs):
    out = runs["port"].out_dir
    lines = open(os.path.join(out, "results.txt")).read().splitlines()
    keys = [ln.split(":")[0] for ln in lines]
    assert keys == list(runs["port_result"])
    assert "LPIPS: nan" in lines
    for sub in TE.EXTRACTION_DIRS:
        files = sorted(os.listdir(os.path.join(out, "extraction", sub)))
        want = (["depth_000002.npz", "depth_000006.npz"] if sub == "depths_raw"
                else ["000002.jpg", "000006.jpg"])
        assert files == want, sub


@pytest.mark.parametrize("i_train,want", [
    ([5, 6, 7, 8, 9, 10, 11, 12], [0, 0]),   # no train frame precedes 2
    ([0, 1, 3, 4, 5, 7, 8, 9], [1, 4]),      # the frame before each
    ([0, 4, 5, 7, 8, 9, 10, 11], [0, 2]),    # a preceding one, not the last
])
def test_init_position_guard_matches_jax(runs, tmp_path, i_train, want):
    """Splits where a test frame's preceding frame is not a train frame:
    both packages start each test view from the same train view's refined
    pose (0 epochs: the cache holds the initial poses)."""
    init = {}
    for name, cls, kw in (("port", TE.Evaluator, {"device": "cpu"}),
                          ("jax", JE.Evaluator, {})):
        out = fork(runs["port"].out_dir, str(tmp_path / name), cache=False)
        cfg = eval_cfg(runs["scene"], out)
        cfg["eval"]["eval_pose_epoch"] = 0
        ev = cls(cfg, verbose=False, **kw)
        ev.train_field.i_train = np.asarray(i_train)
        ev.eval_optimization()
        init[name] = np.asarray(ev.pose_retriever_test[1])
    assert TE.init_positions([2, 6], i_train) == want
    np.testing.assert_array_equal(init["port"], init["jax"])
    np.testing.assert_array_equal(init["port"],
                                  runs["port"].refined_c2w[want])


def test_sampled_rays_repeat(runs, tmp_path):
    """Without injected streams the rays and jitter come from the Trainer's
    generator, reseeded from (seed, 10_000_000 + it): two Evaluators on the
    same run optimize to the same poses, exactly."""
    poses = []
    for name in ("a", "b"):
        out = fork(runs["base"], str(tmp_path / name))
        cfg = eval_cfg(runs["scene"], out)
        cfg["eval"]["eval_pose_epoch"] = 2
        ev = TE.Evaluator(cfg, device="cpu", verbose=False)
        ev.eval_optimization()
        assert ev.eval_l2_trace.shape == (4,)
        assert np.all(np.isfinite(ev.eval_l2_trace))
        poses.append({k: v.numpy() for k, v in
                      ev.pose_retriever_test[0].items()})
    for k in ("r", "t"):
        np.testing.assert_array_equal(poses[0][k], poses[1][k])
        assert np.all(np.abs(poses[0][k]) > 0)
