"""Port parity for the ``Trainer`` and the train state it checkpoints: the
port's ``training/trainer.py`` against the JAX package's on one
Co3D-convention synthetic scene at small widths (the nets of
``test_trainer_e2e.py``), both started from one JAX initial state written as
a checkpoint at ``it = -1``: stage 1, and runs across the stage-1 -> stage-2
transition (pose refinement, ``refine_pose.npz``, canonical-space steps with
the motion net frozen).

Sampling is injected (each package's ``Trainer`` subclassed with a
``_get_step`` that adds ``ray_idx`` / ``t_rand`` drawn from numpy by ``it``),
so both runs see the same rays; the view permutations come from the shared
``np.random`` seeding. The JAX step is compiled once for the module.

Tolerances, f32 on both sides:
  * checkpoints: a state written by one package and read by the other is
    compared exactly (parameters, Adam moments, counts);
  * a port run interrupted and resumed repeats the uninterrupted one
    exactly (same process, same CPU kernels);
  * loss curves, port against JAX: the first Adam steps move every
    parameter by about lr sign(g), and where a gradient entry is near zero
    its sign differs between the packages (the step tests' bounds), so the
    two trajectories drift apart by O(lr) in a few entries each step:
    LOSS_RTOL relative per iteration over 10 iterations (lr warming up to
    1e-3); the drift measured 4e-5 at most; the same bound over 15
    iterations across the transition;
  * refined poses (``refine_pose.npz``), port against JAX: POSE_ATOL, the
    bound of ``test_torch_pose_refinement.py`` (the depths come from each
    package's own render of its own fields); the motion-integrated poses
    of ``do_refine_pose: false``: 1e-5 absolute (the motion chains agree to
    f32 rounding);
  * the Adam layout: the port's update of a loaded state equals optax's
    formula on the JAX layout to float32 rounding (1e-6 relative), and the
    moments after one step of each package differ by (1 - b) times the
    gradient bounds of ``test_torch_step.py`` (1e-3 of each tensor's largest
    gradient entry + 1e-6).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from copenerf_tpu.config.loader import load_config as j_load_config
from copenerf_tpu.data.synthetic import make_scene
from copenerf_tpu.models import fields as JF
from copenerf_tpu.models import torch_io as JIO
from copenerf_tpu.training import checkpoints as JCK
from copenerf_tpu.training import step as JS
from copenerf_tpu.training import trainer as JT
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.models import torch_io as TIO
from copenerf_torch.training import checkpoints as TCK
from copenerf_torch.training import step as TS
from copenerf_torch.training import trainer as TT
from copenerf_torch.utils import profiling as TP
from test_torch_step import grads_as_jax

H, W = 24, 32
N_FRAMES = 6          # i_test = [4]: 5 train views, 5 iterations an epoch
N_SAMPLES = 16
LOSS_RTOL = 3e-4
POSE_ATOL = 1e-4
B1, B2, EPS = 0.9, 0.999, 1e-8


def tiny_cfg(scene, out_dir, **training):
    path, name = scene
    cfg = j_load_config(None)
    cfg["dataloading"].update({"path": path, "scene": [name]})
    cfg["rendering"]["depth_range"] = [0.5, 3.5]
    cfg["training"].update({
        "out_dir": out_dir, "original_resolution": [H, W],
        "resolution": [H, W], "vis_resolution": [12, 16],
        "n_training_points": 64, "patch_size": 4, "n_devices": 1,
        "scheduling_start": 5, "scheduling_epoch": 3,
        "start_query_world_epoch": 100, "end_smooth_epoch": 100,
        "nb_warm_up_it": 10, "pretrained_sdf_path": None,
        "checkpoint_every": 100, "eval_pose_every": 1, "print_every": 5,
        "depth_bound_update_every_milestones": [0, 0, 0], **training})
    cfg["neus_sdf_network"].update({"d_hidden": 64, "n_layers": 4,
                                    "skip_in": [2], "d_out": 33})
    cfg["neus_rendering_network"].update({"d_feature": 32, "d_hidden": 32,
                                          "n_layers": 2})
    cfg["motion_network"].update({"d_hidden": 32, "n_layers": 2,
                                  "skip_in": [1]})
    cfg["neus_nerf"].update({"D": 2, "W": 32})
    cfg["neus_renderer"].update({"n_samples": N_SAMPLES, "n_importance": 16,
                                 "up_sample_steps": 2})
    return cfg


def sampling(it):
    """Iteration ``it``'s rays (4 whole 4x4 patches) and jitter."""
    rng = np.random.default_rng(1000 + it)
    w_adj = W - 3
    corners = rng.choice((H - 3) * w_adj, 4, replace=False)
    off = np.arange(4)
    offsets = (off[None, :] + off[:, None] * W).reshape(-1)
    start = (corners // w_adj) * W + corners % w_adj
    idx = (start[:, None] + offsets[None, :]).reshape(-1)
    return idx, rng.uniform(size=(64, N_SAMPLES)).astype(np.float32)


_JAX_STEPS = {}


class JaxTrainer(JT.Trainer):
    """The JAX ``Trainer`` with injected sampling; records each loss."""

    def _get_step(self, stage1, train_motion):
        static = JS.StepStatic(
            h=self.h, w=self.w, patch_size=self.patch_size,
            n_points=self.rays_per_step, stage1=stage1,
            n_images=self.total_nb_images,
            nb_sample_timestep=self.nb_sample_timestep, n_ref=self.n_ref,
            train_motion=train_motion,
            sdf_cons_pose_grad=self.tr["sdf_consistency_enable_pose_grad"],
            use_flow_rgb=True, use_sdf_consistency=True,
            smooth_scale=self.s, inject_sampling=True)
        if static not in _JAX_STEPS:
            _JAX_STEPS[static] = JS.build_train_step(self.field_cfgs,
                                                     self.rcfg, static)
        jstep = _JAX_STEPS[static]
        self.losses = getattr(self, "losses", [])

        def step(state, batch, key):
            idx, t_rand = sampling(self.it)
            batch = dict(batch, ray_idx=jnp.asarray(idx, jnp.int32),
                         t_rand=jnp.asarray(t_rand))
            state, metrics = jstep(state, batch, key)
            self.losses.append(float(metrics["loss"]))
            return state, metrics

        return step


class PortTrainer(TT.Trainer):
    """The port's ``Trainer`` with the same injected sampling."""

    def _get_step(self, stage1, train_motion):
        static = TS.StepStatic(
            h=self.h, w=self.w, patch_size=self.patch_size,
            n_points=self.rays_per_step, stage1=stage1,
            n_images=self.total_nb_images,
            nb_sample_timestep=self.nb_sample_timestep, n_ref=self.n_ref,
            train_motion=train_motion,
            sdf_cons_pose_grad=self.tr["sdf_consistency_enable_pose_grad"],
            use_flow_rgb=True, use_sdf_consistency=True,
            smooth_scale=self.s, inject_sampling=True)
        tstep = TS.build_train_step(self.rcfg, static)
        self.losses = getattr(self, "losses", [])

        def step(state, batch, generator):
            idx, t_rand = sampling(self.it)
            batch = dict(batch, ray_idx=torch.from_numpy(idx),
                         t_rand=torch.from_numpy(t_rand))
            metrics = tstep(state, batch, generator)
            self.losses.append(float(metrics["loss"]))
            return metrics

        return step


def port_trainer(cfg, cls=PortTrainer):
    return cls(cfg, device="cpu", verbose=False)


def flat_state(tree) -> dict:
    return TCK._flatten(jax.device_get(tree))


def assert_states_equal(got, ref):
    got, ref = flat_state(got), flat_state(ref)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)


def write_init(scene, out_dir, seed=0):
    """The JAX initial train state as a checkpoint at it = -1."""
    cfg = tiny_cfg(scene, out_dir)
    params = JF.init_all_fields(jax.random.PRNGKey(seed),
                                JF.configs_from_cfg(cfg))
    JCK.save_checkpoint(out_dir, JS.init_train_state(params),
                        {"epoch_it": -1, "it": -1, "depth_range": [0.5, 3.5]})


def fork(src, dst, sub="weights", refine_pose=True):
    """A new run directory holding ``src``'s checkpoint ``sub`` (the latest
    by default) as its latest, and its ``refine_pose.npz`` if it has one."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, "models", sub),
                    os.path.join(dst, "models", "weights"))
    pose = os.path.join(src, "models", "refine_pose.npz")
    if refine_pose and os.path.isfile(pose):
        shutil.copy(pose, os.path.join(dst, "models"))
    return dst


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")),
                      n_frames=N_FRAMES, h=H, w=W)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """Every run of the cross-package and resume tests, once. Each Trainer
    is built and trained before the next one is built: every construction
    seeds the process's ``np.random``, as a new process would."""
    root = tmp_path_factory.mktemp("runs")
    init = str(root / "init")
    write_init(scene, init)
    r, loaded, pose_eval = {}, {}, {}

    def run(name, src, epochs, package, save=False):
        out = fork(src, str(root / name))
        if package == "jax":
            t = JaxTrainer(tiny_cfg(scene, out), verbose=False)
            loaded[name] = jax.device_get(t.state)
        else:
            t = port_trainer(tiny_cfg(scene, out))
            loaded[name] = TS.train_state_to_jax(t.state)
        pose_eval[name] = t.pose_evaluation()
        t.train(max_epochs=epochs)
        if save:
            t.save_checkpoint()
        r[name] = t

    run("J2", init, 2, "jax")
    run("P2", init, 2, "port")
    run("J1", init, 1, "jax", save=True)
    run("P1", init, 1, "port", save=True)
    # Each package's epoch-0 checkpoint resumed in both packages.
    for src in ("J1", "P1"):
        run(f"P_from_{src}", r[src].out_dir, 1, "port")
        run(f"J_from_{src}", r[src].out_dir, 1, "jax")
    r["loaded"], r["pose_eval"] = loaded, pose_eval
    return r


def test_loss_curves_match_jax(runs):
    """Two epochs (10 iterations, across the epoch boundary) from one
    state: the port's losses against the JAX package's."""
    got, ref = np.asarray(runs["P2"].losses), np.asarray(runs["J2"].losses)
    assert len(got) == len(ref) == 10
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert runs["P2"].it == runs["J2"].it == 9


def test_jax_checkpoint_resumes_in_port(runs):
    """The port loads the JAX run's epoch-0 checkpoint bit for bit, replays
    the epoch's view permutation, and its next epoch follows the JAX
    package's uninterrupted second epoch."""
    assert_states_equal(runs["loaded"]["P_from_J1"],
                        jax.device_get(runs["J1"].state))
    assert int(runs["loaded"]["P_from_J1"]["opt_fields"].count) == 5
    np.testing.assert_allclose(runs["P_from_J1"].losses, runs["J2"].losses[5:],
                               rtol=LOSS_RTOL, atol=0)


def test_port_checkpoint_resumes_in_jax(runs):
    """The JAX package loads the port's epoch-0 checkpoint bit for bit; its
    next epoch follows the one it trains from its own checkpoint."""
    assert_states_equal(runs["loaded"]["J_from_P1"],
                        TS.train_state_to_jax(runs["P1"].state))
    np.testing.assert_allclose(runs["J_from_P1"].losses,
                               runs["J_from_J1"].losses, rtol=LOSS_RTOL,
                               atol=0)


def test_port_resume_equals_uninterrupted(runs):
    """1 epoch, save, resume, 1 epoch == 2 epochs: losses, iteration count
    and the final train state, exactly."""
    assert_states_equal(runs["loaded"]["P_from_P1"],
                        TS.train_state_to_jax(runs["P1"].state))
    assert runs["P1"].losses + runs["P_from_P1"].losses == runs["P2"].losses
    assert runs["P_from_P1"].it == runs["P2"].it
    assert_states_equal(TS.train_state_to_jax(runs["P_from_P1"].state),
                        TS.train_state_to_jax(runs["P2"].state))
    assert runs["P_from_P1"].depth_range == runs["P2"].depth_range


def test_pose_evaluation_matches_jax(runs):
    """ATE and RPE of the same motion net (the port's epoch-0 state, read by
    the JAX package): the motion chains agree to f32 rounding."""
    got = runs["pose_eval"]["P_from_P1"]
    ref = runs["pose_eval"]["J_from_P1"]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4, atol=1e-7)
    assert np.isfinite(got[1:]).all()


def test_sampled_run_resumes_exactly(scene, tmp_path):
    """The port's own sampling (a device generator seeded from (seed, it)):
    2 epochs equal 1 epoch, save, resume, 1 epoch, exactly; the loss log
    and the throughput journal are written."""
    init = str(tmp_path / "init")
    write_init(scene, init)
    full = port_trainer(tiny_cfg(scene, fork(init, str(tmp_path / "a"))),
                        TT.Trainer)
    full.train(max_epochs=2)
    half = port_trainer(tiny_cfg(scene, fork(init, str(tmp_path / "b"))),
                        TT.Trainer)
    half.train(max_epochs=1)
    half.save_checkpoint()
    rest = port_trainer(tiny_cfg(scene, half.out_dir), TT.Trainer)
    rest.train(max_epochs=1)
    assert_states_equal(TS.train_state_to_jax(rest.state),
                        TS.train_state_to_jax(full.state))

    def epoch_losses(out_dir):
        lines = [json.loads(s) for s in
                 open(os.path.join(out_dir, "logs", "scalars.jsonl"))]
        return [(d["step"], d["value"]) for d in lines
                if d["tag"] == "loss_epoch/loss"]

    assert epoch_losses(full.out_dir) == epoch_losses(half.out_dir)
    assert np.isfinite([v for _, v in epoch_losses(full.out_dir)]).all()
    journal = [json.loads(s) for s in
               open(os.path.join(full.out_dir, "logs", "throughput.jsonl"))]
    assert [d["epoch"] for d in journal] == [0, 1]
    assert all(d["ms_per_it"] > 0 for d in journal)
    # The rate of the epoch's synchronized step time (64 rays a step).
    for d in journal:
        assert d["rays_per_sec"] == pytest.approx(
            1e3 * 64 / d["ms_per_it_steps"])


def test_plain_mode_raises(scene, tmp_path):
    """``fused_kernels: off`` is refused in the open (YAML reads a bare off
    as False)."""
    for mode in ("off", False):
        with pytest.raises(ValueError, match="fused_kernels"):
            port_trainer(tiny_cfg(scene, str(tmp_path / "c"),
                                  fused_kernels=mode), TT.Trainer)


def test_visualize_and_render_train_views(scene, tmp_path):
    """The port's visualization (images, flow, depth metrics, the adaptive
    depth range) and the train-view render on the CPU."""
    out = str(tmp_path / "v")
    t = port_trainer(tiny_cfg(scene, out, depth_bound_lr=[0.5, 0.5, 0.5]),
                     TT.Trainer)
    t.it = 0
    res = t.visualize(1, 0)
    for k in ("color", "depth", "weighted_z", "normal", "depth_highest"):
        assert np.isfinite(res[k]).all(), k
    assert res["color"].shape == (12, 16, 3)
    target = int(t.train_field.i_train[1])
    files = os.listdir(os.path.join(out, "rendering", "0000_vis"))
    for suffix in ("img", "disparity", "normal", "flow",
                   "disparity_highest_weight"):
        assert f"{target:04d}_{suffix}.png" in files, suffix
    expect = 3.5 * 0.5 + float(res["weighted_z"].max()) * 1.1 * 0.5
    assert t.depth_range[1] == pytest.approx(expect)
    t.logger.flush()
    tags = {json.loads(s)["tag"] for s in
            open(os.path.join(out, "logs", "scalars.jsonl"))}
    assert "depth_eval/abs_rel" in tags
    depths = t.render_train_views(views=[0, 2])
    assert depths.shape == (2, H, W) and np.isfinite(depths).all()
    assert len(os.listdir(os.path.join(out, "extraction_stage1",
                                       "depths"))) == 2


# ---------------------------------------------------------------------------
# Stage 2: the transition, the refined poses, canonical-space epochs
# ---------------------------------------------------------------------------

def stage2_cfg(scene, out_dir, **training):
    """Epoch 0 in stage 1, the transition at epoch 1 (20 refinement
    epochs), a checkpoint every epoch; the motion net frozen from there."""
    return tiny_cfg(scene, out_dir, start_query_world_epoch=1,
                    pose_refine_epochs=20, checkpoint_every=1, **training)


def refine_pose(t):
    return np.load(os.path.join(t.out_dir, "models",
                                "refine_pose.npz"))["init_c2w"]


def adam_counts(state):
    return {k: int(state[k].count) for k in ("opt_fields", "opt_motion")}


@pytest.fixture(scope="module")
def stage2_runs(scene, tmp_path_factory):
    """Epochs across the transition: 4 in the JAX package, 3 in the port;
    each package's epoch-2 checkpoint resumed for 1 epoch (the JAX one in
    both packages, the port's in the JAX package), and the port's
    transition-epoch checkpoint resumed in the port. Built and trained one
    at a time, as ``runs`` does."""
    root = tmp_path_factory.mktemp("stage2")
    init = str(root / "init")
    write_init(scene, init)
    r = {}

    def run(name, src, epochs, package, sub="weights"):
        out = fork(src, str(root / name), sub)
        if package == "jax":
            t = JaxTrainer(stage2_cfg(scene, out), verbose=False)
        else:
            t = port_trainer(stage2_cfg(scene, out))
        t.train(max_epochs=epochs)
        r[name] = t

    run("J4", init, 4, "jax")
    run("P3", init, 3, "port")
    run("J_from_J4e2", r["J4"].out_dir, 1, "jax", sub="weights_2")
    run("P_from_J4e2", r["J4"].out_dir, 1, "port", sub="weights_2")
    run("J_from_P3", r["P3"].out_dir, 1, "jax")
    run("P_from_P3_e1", r["P3"].out_dir, 1, "port", sub="weights_1")
    return r


def test_stage2_loss_curves_match_jax(stage2_runs):
    """15 iterations across the transition (5 in stage 1, 10 in stage 2):
    the losses, the refined poses the transition wrote, and both Adam
    counts (the motion count stands still in stage 2)."""
    got, ref = stage2_runs["P3"], stage2_runs["J4"]
    assert len(got.losses) == 15 and len(ref.losses) == 20
    np.testing.assert_allclose(got.losses, ref.losses[:15], rtol=LOSS_RTOL,
                               atol=0)
    assert got.query_in_canonical_space and ref.query_in_canonical_space
    assert not got.pose_refine_fell_back
    poses = refine_pose(got)
    assert poses.shape == (5, 4, 4) and poses.dtype == np.float32
    np.testing.assert_allclose(poses, refine_pose(ref), rtol=0,
                               atol=POSE_ATOL)
    world = list(got.train_field.i_train).index(got.world_cam_idx)
    np.testing.assert_allclose(poses[world], np.eye(4), rtol=0, atol=1e-6)
    assert np.abs(np.delete(poses, world, 0) - np.eye(4)).max() > 1e-3
    assert adam_counts(TS.train_state_to_jax(got.state)) == {
        "opt_fields": 15, "opt_motion": 5}
    assert adam_counts(ref.state) == {"opt_fields": 20, "opt_motion": 5}
    summary = got.transition_summary
    assert summary["epoch"] == 1 and not summary["fell_back"]
    assert summary["render_train_views_ms"] > 0 < summary["pose_refine_ms"]
    refine_losses = [json.loads(s)["value"] for s in open(os.path.join(
        got.out_dir, "logs", "scalars.jsonl")) if '"poseRefine/_loss"' in s]
    assert len(refine_losses) == 20


def test_jax_stage2_checkpoint_resumes_in_port(stage2_runs):
    """The JAX run's epoch-2 checkpoint and ``refine_pose.npz`` resumed in
    the port: its table holds the JAX poses, and its epoch (the replayed
    view permutation) follows the JAX run's uninterrupted fourth epoch."""
    pt = stage2_runs["P_from_J4e2"]
    poses = refine_pose(stage2_runs["J4"])
    table = pt._world_mat_dev.numpy()
    world = list(pt.train_field.i_train).index(pt.world_cam_idx)
    np.testing.assert_array_equal(np.delete(table, world, 0),
                                  np.delete(poses, world, 0))
    np.testing.assert_array_equal(table[world], np.eye(4))
    np.testing.assert_allclose(pt.losses, stage2_runs["J4"].losses[15:],
                               rtol=LOSS_RTOL, atol=0)
    assert adam_counts(TS.train_state_to_jax(pt.state)) == {
        "opt_fields": 20, "opt_motion": 5}


def test_port_stage2_checkpoint_resumes_in_jax(stage2_runs):
    """The port's epoch-2 checkpoint and ``refine_pose.npz`` resumed in the
    JAX package: it reads the port's poses, and its epoch follows the one it
    trains from its own epoch-2 checkpoint."""
    jt = stage2_runs["J_from_P3"]
    np.testing.assert_array_equal(np.asarray(jt.pose_retriever[1]),
                                  refine_pose(stage2_runs["P3"]))
    assert len(jt.losses) == 5
    np.testing.assert_allclose(jt.losses, stage2_runs["J_from_J4e2"].losses,
                               rtol=LOSS_RTOL, atol=0)


def test_transition_epoch_checkpoint_resumes_on_refined_poses(
        stage2_runs, scene, tmp_path):
    """The checkpoint saved in the transition epoch resumes in the port on
    the refined poses: its next epoch repeats the uninterrupted run's
    exactly (the JAX package trains that epoch on the identity). Without
    ``refine_pose.npz`` the resume raises, naming the file."""
    full, resumed = stage2_runs["P3"], stage2_runs["P_from_P3_e1"]
    assert resumed.losses == full.losses[10:]
    assert_states_equal(TS.train_state_to_jax(resumed.state),
                        TS.train_state_to_jax(full.state))
    np.testing.assert_array_equal(resumed._world_mat_dev.numpy(),
                                  full._world_mat_dev.numpy())
    out = fork(full.out_dir, str(tmp_path / "no_poses"), "weights_1",
               refine_pose=False)
    t = port_trainer(stage2_cfg(scene, out))
    with pytest.raises(FileNotFoundError, match="refine_pose.npz"):
        t.train(max_epochs=1)
    assert t.it == 9


@pytest.fixture
def transition_init(scene, tmp_path):
    """A run directory holding the JAX initial state."""
    out = str(tmp_path / "t")
    write_init(scene, out)
    return out


@pytest.mark.parametrize("planted", [RuntimeError, torch.OutOfMemoryError,
                                     OSError, MemoryError])
def test_transition_falls_back_only_on_memory_and_io(scene, transition_init,
                                                     planted):
    """An error from the renderer inside the transition: a RuntimeError (a
    kernel's failed build or launch) propagates; out of memory and IO fall
    back to the motion-integrated poses, those of ``do_refine_pose:
    false``."""
    t = port_trainer(stage2_cfg(scene, transition_init), TT.Trainer)

    def render_image(*args, **kwargs):
        raise planted("planted")

    t.image_renderer.render_image = render_image
    if planted is RuntimeError:
        with pytest.raises(RuntimeError, match="planted"):
            t.stage2_transition(1)
        assert not os.path.isfile(t._refine_pose_path())
        return
    t.stage2_transition(1)
    assert t.pose_refine_fell_back and t.transition_summary["fell_back"]
    fell_back = refine_pose(t)
    os.remove(t._refine_pose_path())
    t = port_trainer(stage2_cfg(scene, transition_init,
                                do_refine_pose=False), TT.Trainer)
    t.stage2_transition(1)
    assert not t.pose_refine_fell_back
    np.testing.assert_array_equal(fell_back, refine_pose(t))


def test_no_pose_refinement_matches_jax(scene, transition_init, tmp_path):
    """``do_refine_pose: false``: both packages take the motion-integrated
    poses re-anchored on the world camera; the port's stage-2 visualization
    renders them and draws no flow (4 files)."""
    cfg = stage2_cfg(scene, transition_init, do_refine_pose=False)
    jt = JaxTrainer(cfg, verbose=False)
    jt.stage2_transition(1)
    ref = refine_pose(jt)
    os.remove(os.path.join(transition_init, "models", "refine_pose.npz"))
    pt = port_trainer(stage2_cfg(scene, transition_init,
                                 do_refine_pose=False), TT.Trainer)
    pt.stage2_transition(1)
    np.testing.assert_allclose(refine_pose(pt), ref, rtol=0, atol=1e-5)
    assert pt.lr_state.cur_motion_lr == 0.0
    pt.it = 0
    res = pt.visualize(1, 1)
    assert np.isfinite(res["color"]).all() and "pts_flat" not in res
    target = int(pt.train_field.i_train[1])
    files = sorted(os.listdir(os.path.join(transition_init, "rendering",
                                           "0000_vis")))
    assert files == sorted(f"{target:04d}_{k}.png" for k in (
        "img", "disparity", "normal", "disparity_highest_weight"))


# ---------------------------------------------------------------------------
# The train state in the JAX layout
# ---------------------------------------------------------------------------

def _jax_state_with_moments(cfg, seed=1, count=3):
    params = JF.init_all_fields(jax.random.PRNGKey(seed),
                                JF.configs_from_cfg(cfg))
    state = jax.device_get(JS.init_train_state(params))
    rng = np.random.default_rng(seed)
    for key in ("opt_fields", "opt_motion"):
        st = state[key]
        n = st.mu.shape[0]
        state[key] = st._replace(
            count=np.asarray(count, np.int32),
            mu=rng.normal(size=n).astype(np.float32) * 1e-2,
            nu=rng.uniform(size=n).astype(np.float32) * 1e-4)
    return state


def test_train_state_round_trip(scene, tmp_path):
    """``train_state_to_jax(train_state_from_jax(s))`` is ``s`` leaf for
    leaf, and through a checkpoint file of either package."""
    cfg = tiny_cfg(scene, str(tmp_path))
    ref = _jax_state_with_moments(cfg)
    tcfgs = TF.configs_from_cfg(cfg)
    state = TS.train_state_from_jax(ref, tcfgs, device="cpu")
    got = TS.train_state_to_jax(state)
    assert_states_equal(got, ref)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, got["opt_fields"]._asdict())) == \
        jax.tree_util.tree_structure(ref["opt_fields"]._asdict())
    sizes = {k: sum(p.numel() for n in nets for p in state["fields"][n]
                    .parameters()) for k, nets in TS.OPTIMIZER_NETS.items()}
    assert got["opt_fields"].mu.shape == (sizes["opt_fields"],)
    assert got["opt_motion"].nu.shape == (sizes["opt_motion"],)
    # A port checkpoint read by the JAX package, and the reverse.
    TCK.save_checkpoint(str(tmp_path / "p"), got, {"it": 3})
    jstate, scalars = JCK.load_checkpoint(str(tmp_path / "p"))
    assert scalars == {"it": 3}
    assert_states_equal(jstate, ref)
    JCK.save_checkpoint(str(tmp_path / "j"), ref, {"it": 3})
    tstate, _ = TCK.load_checkpoint(str(tmp_path / "j"))
    assert_states_equal(TS.train_state_to_jax(
        TS.train_state_from_jax(tstate, tcfgs, device="cpu")), ref)


def test_fresh_optimizer_is_jax_init_state(scene, tmp_path):
    """Before its first step torch's Adam holds no state: it converts to
    the JAX package's ``init_train_state`` (count 0, zero moments)."""
    cfg = tiny_cfg(scene, str(tmp_path))
    params = jax.device_get(JF.init_all_fields(jax.random.PRNGKey(2),
                                               JF.configs_from_cfg(cfg)))
    fields = X.params_from_jax(params, TF.configs_from_cfg(cfg), "cpu")
    assert_states_equal(TS.train_state_to_jax(TS.init_train_state(fields)),
                        jax.device_get(JS.init_train_state(params)))


def test_exchanged_step_matches_jax(scene, tmp_path):
    """One step of each package from the same loaded state (moments and
    count 3) and the same injected batch. The port's update equals optax's
    formula applied in the JAX layout to the port's own gradients; its
    moments are within the step tests' gradient bounds of the JAX ones."""
    cfg = tiny_cfg(scene, str(tmp_path))
    ref = _jax_state_with_moments(cfg)
    jt = JaxTrainer(cfg, verbose=False)
    pt = port_trainer(tiny_cfg(scene, str(tmp_path)))
    jt.state = jax.tree_util.tree_map(jnp.asarray, ref)
    pt.state = TS.train_state_from_jax(ref, pt.field_cfgs, device="cpu")
    jt.it = pt.it = 4
    lr, motion_lr = 1e-3, 5e-4
    jstate, _ = jt._get_step(True, True)(jt.state, jt._make_batch(1, lr,
                                                                   motion_lr),
                                         jax.random.PRNGKey(0))
    pt._get_step(True, True)(pt.state, pt._make_batch(1, lr, motion_lr),
                             pt.generator)
    got = TS.train_state_to_jax(pt.state)
    jstate = jax.device_get(jstate)
    fields = pt.state["fields"]
    for key, nets in TS.OPTIMIZER_NETS.items():
        step_lr = lr if key == "opt_fields" else motion_lr
        old, new, jnew = ref[key], got[key], jstate[key]
        assert int(new.count) == int(jnew.count) == 4
        grads = {n: grads_as_jax(fields[n]) for n in nets}
        g = ravel_pytree(grads)[0]
        mu = B1 * old.mu + (1 - B1) * g
        nu = B2 * old.nu + (1 - B2) * g * g
        # Rounding of the two terms (torch lerps, optax scales and adds).
        assert np.all(np.abs(new.mu - mu) <= 1e-6 * (
            B1 * np.abs(old.mu) + (1 - B1) * np.abs(g)) + 1e-12)
        assert np.all(np.abs(new.nu - nu) <= 1e-6 * (
            B2 * old.nu + (1 - B2) * g * g) + 1e-15)
        p_old = ravel_pytree({n: ref["params"][n] for n in nets})[0]
        p_new = ravel_pytree({n: got["params"][n] for n in nets})[0]
        upd = (mu / (1 - B1 ** 4)) / (np.sqrt(nu / (1 - B2 ** 4)) + EPS)
        np.testing.assert_allclose(p_new, p_old - step_lr * upd, rtol=0,
                                   atol=1e-6 * step_lr + 1e-7)
        # Moments against the JAX step: (1 - b1) times the gradient bound
        # of each tensor (1e-3 of its largest entry + 1e-6).
        bound = np.concatenate([
            np.full(np.size(leaf), 1e-3 * np.abs(leaf).max() + 1e-6)
            for leaf in jax.tree_util.tree_leaves(grads)])
        assert np.all(np.abs(new.mu - jnew.mu) <= (1 - B1) * bound)


def test_migrate_train_state_matches_jax(scene, tmp_path):
    """A checkpoint with per-leaf Adam moments migrates to the flat layout
    as the JAX package migrates it."""
    cfg = tiny_cfg(scene, str(tmp_path))
    params = jax.device_get(JF.init_all_fields(jax.random.PRNGKey(3),
                                               JF.configs_from_cfg(cfg)))
    rng = np.random.default_rng(5)
    old = {"params": params}
    for key, nets in TS.OPTIMIZER_NETS.items():
        sub = {n: params[n] for n in nets}
        moments = [jax.tree_util.tree_map(
            lambda x: rng.normal(size=np.shape(x)).astype(np.float32), sub)
            for _ in range(2)]
        old[key] = (np.asarray(2, np.int32), *moments)
    got = TS.migrate_train_state({k: v for k, v in old.items()})
    ref = JS.migrate_train_state({k: v for k, v in old.items()})
    for key in TS.OPTIMIZER_NETS:
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    flat = (np.asarray(1, np.int32), np.zeros(3, np.float32),
            np.ones(3, np.float32))
    assert TS.migrate_train_state({"opt_fields": flat})["opt_fields"] is flat


@pytest.mark.parametrize("tree", [
    {"a": {"b": np.arange(3.0), "c": (np.int32(1), [np.ones(2), None])}},
    {"x": [], "y": (np.zeros((2, 2), np.float32),)},
])
def test_flatten_matches_jax(tree, tmp_path):
    """The npz key layout of ``_flatten`` and ``save_pytree`` /
    ``load_pytree`` across the packages."""
    got, ref = TCK._flatten(tree), JCK._flatten(tree)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    TCK.save_pytree(str(tmp_path / "t.npz"), tree)
    back = JCK.load_pytree(str(tmp_path / "t.npz"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    JCK.save_pytree(str(tmp_path / "j.npz"), tree)
    for a, b in zip(jax.tree_util.tree_leaves(TCK.load_pytree(
            str(tmp_path / "j.npz"))), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_load_pretrained_sdf_matches_jax(tmp_path):
    """A reference-style SDF state dict (``lin{l}.weight_v`` (out, in),
    ``weight_g`` (out, 1), ``bias``) loads into the port's SDF net as the
    JAX loader's tree does through the weight exchange."""
    cfg = JF.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), d_out=33)
    g = torch.Generator().manual_seed(6)
    sd = {}
    for l in range(cfg.n_layers + 1):
        d_in, d_out = TF.idr_layer_dims(cfg, l)
        sd[f"lin{l}.weight_v"] = torch.randn((d_out, d_in), generator=g)
        sd[f"lin{l}.weight_g"] = torch.rand((d_out, 1), generator=g) + 0.5
        sd[f"lin{l}.bias"] = torch.randn((d_out,), generator=g)
    path = str(tmp_path / "model.pt")
    torch.save(sd, path)
    tcfg = TF.SDFConfig(**dataclasses.asdict(cfg))
    net = TIO.load_pretrained_sdf(TF.SDFNetwork(tcfg), path)
    ref = X.params_from_jax(
        {"sdf": jax.device_get(JIO.load_pretrained_sdf(path, cfg.n_layers))},
        {"sdf": tcfg}, device="cpu")["sdf"]
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              ref.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_step_timer_and_trace_on_cpu(tmp_path):
    """The JSONL journal of ``StepTimer``: one line a ``log`` call, written
    as it is made, none without a path; a CPU ``trace`` writes its Chrome
    trace, reports no device time and takes its annotation's spans out of
    the ``*_outside`` wall time."""
    timer = TP.StepTimer(log_path=str(tmp_path / "t.jsonl"))
    timer.log(7, epoch=1, rays_per_sec=2.0)
    timer.log(8, epoch=2)
    lines = [json.loads(s) for s in open(tmp_path / "t.jsonl")]
    assert lines == [{"step": 7, "epoch": 1, "rays_per_sec": 2.0},
                     {"step": 8, "epoch": 2}]
    TP.StepTimer().log(9)
    with TP.trace(str(tmp_path / "plugins"), "cpu",
                  annotation="copenerf.visualize") as summary:
        torch.ones(64, 64) @ torch.ones(64, 64)
        with TP.span("copenerf.visualize"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    assert os.path.isfile(summary["trace"])
    assert summary["wall_ms"] > 0 and summary["device_busy_ms"] == 0.0
    assert 0 < summary["wall_ms_outside"] < summary["wall_ms"]
