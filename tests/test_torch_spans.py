"""The port's spans (``copenerf_torch.utils.profiling``): off they record
nothing and call no profiler; on they nest and parent as documented, also
across threads; the train step, the view render and the pose loss record
their trees; spans change nothing the program computes; the Trainer's
profiler window shows them. CPU, small widths, no JAX."""

from __future__ import annotations

import collections
import json
import threading

import numpy as np
import pytest
import torch

from copenerf_torch.config.loader import default_config
from copenerf_torch.data.synthetic import make_scene
from copenerf_torch.evaluation.evaluator import pose_loss
from copenerf_torch.evaluation.render import ImageRenderer
from copenerf_torch.training.trainer import Trainer
from copenerf_torch.utils import profiling as P

H, W = 24, 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")), n_frames=6,
                      h=H, w=W)


def tiny_cfg(scene, out_dir, **training):
    path, name = scene
    cfg = default_config()
    cfg["dataloading"].update({"path": path, "scene": [name]})
    cfg["rendering"]["depth_range"] = [0.5, 3.5]
    cfg["training"].update({
        "out_dir": out_dir, "original_resolution": [H, W],
        "resolution": [H, W], "vis_resolution": [12, 16],
        "n_training_points": 64, "patch_size": 4, "n_devices": 1,
        "start_query_world_epoch": 100, "end_smooth_epoch": 100,
        "pretrained_sdf_path": None, "checkpoint_every": 100,
        "eval_pose_every": 100, "print_every": 0,
        "depth_bound_update_every_milestones": [0, 0, 0], **training})
    cfg["neus_sdf_network"].update({"d_hidden": 64, "n_layers": 4,
                                    "skip_in": [2], "d_out": 33})
    cfg["neus_rendering_network"].update({"d_feature": 32, "d_hidden": 32,
                                          "n_layers": 2})
    cfg["motion_network"].update({"d_hidden": 32, "n_layers": 2,
                                  "skip_in": [1]})
    cfg["neus_nerf"].update({"D": 2, "W": 32})
    cfg["neus_renderer"].update({"n_samples": 8, "n_importance": 8,
                                 "up_sample_steps": 2})
    return cfg


def trainer(scene, tmp_path, **training):
    return Trainer(tiny_cfg(scene, str(tmp_path), **training), device="cpu",
                   verbose=False)


def run_steps(tr, stage1: bool, n: int = 2):
    """``n`` steps of the Trainer's own step; stage 2 through identity
    refined poses. Returns each step's loss."""
    if not stage1:
        tr.query_in_canonical_space = True
        tr._set_world_mats(np.tile(np.eye(4, dtype=np.float32),
                                   (tr.train_field.N_imgs, 1, 1)))
    step = tr._get_step(stage1=stage1, train_motion=stage1)
    losses = []
    for it in range(1, n + 1):
        batch = tr._make_batch(it % tr.train_field.N_imgs, 1e-3, 1e-4)
        tr.generator.manual_seed(it)
        losses.append(step(tr.state, batch, tr.generator)["loss"])
    return losses


def names(log) -> collections.Counter:
    return collections.Counter(name for name, *_ in log)


def parent_of(log, i):
    p = log[i][4]
    return None if p is None else log[p][0]


def test_spans_off_record_nothing_and_call_no_profiler(scene, tmp_path,
                                                       monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    off = P.span("copenerf.a")
    assert off is P.span("copenerf.b")
    with off as inside:
        assert inside is None
    run_steps(trainer(scene, tmp_path), stage1=True, n=1)
    assert calls == []
    with P.record_spans() as log:
        pass
    assert log == []


def test_spans_nest_and_parent_across_threads():
    with P.record_spans() as log:
        with P.span("copenerf.a"):
            with P.span("copenerf.a.b"):
                pass
        with P.span("copenerf.step.backward"):
            # A thread with no open span of its own: its spans belong to
            # the recording thread's innermost one.
            t = threading.Thread(target=lambda: P.span(
                "copenerf.kernel.k").__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()

        @P.spanned("copenerf.c")
        def inner():
            return 7

        assert inner() == 7 and inner.__name__ == "inner"
    assert [e[0] for e in log] == ["copenerf.a.b", "copenerf.a",
                                   "copenerf.kernel.k",
                                   "copenerf.step.backward", "copenerf.c"]
    me = threading.get_ident()
    assert [parent_of(log, i) for i in range(len(log))] == [
        "copenerf.a", None, "copenerf.step.backward", None, None]
    assert [e[1] == me for e in log] == [True, True, False, True, True]
    for name, _, start, end, parent in log:
        assert start <= end
        if parent is not None:
            assert log[parent][2] <= start and end <= log[parent][3]
    with pytest.raises(RuntimeError):
        with P.record_spans():
            with P.record_spans():
                pass


STEP_TREE = {
    # name: (spans a step, parent)
    "copenerf.step": (1, None),
    "copenerf.step.sample": (2, "copenerf.step"),
    "copenerf.step.optimizer": (2, "copenerf.step"),
    "copenerf.render": (1, "copenerf.step"),
    "copenerf.render.importance": (1, "copenerf.render"),
    "copenerf.render.core": (1, "copenerf.render"),
    "copenerf.step.losses": (1, "copenerf.step"),
    "copenerf.step.backward": (1, "copenerf.step"),
}


@pytest.mark.parametrize("stage1", [True, False])
def test_a_step_records_its_tree_once_a_step(scene, tmp_path, stage1):
    tr = trainer(scene, tmp_path)
    with P.record_spans() as log:
        run_steps(tr, stage1, n=2)
    tree = dict(STEP_TREE)
    if stage1:
        tree["copenerf.step.motion"] = (1, "copenerf.step")
    # The plain path launches no kernel of the port's and packs nothing.
    assert names(log) == {k: 2 * n for k, (n, _) in tree.items()}
    for i, (name, *_) in enumerate(log):
        assert parent_of(log, i) == tree[name][1], name


def test_a_view_and_a_pose_loss_record_their_spans(scene, tmp_path):
    tr = trainer(scene, tmp_path)
    fields = tr.state["fields"]
    renderer = ImageRenderer(tr.rcfg, chunk=128, device="cpu")
    k = np.asarray(tr.train_field.K[0], np.float32)
    with P.record_spans() as log:
        renderer.render_image(fields, k, np.eye(4, dtype=np.float32),
                              np.eye(4, dtype=np.float32), 0.0, (8, 40),
                              (0.5, 3.5), 1.0)
    # 320 pixels in chunks of 128: 3 chunks, one host fetch.
    assert names(log) == {"copenerf.view": 1, "copenerf.view.chunk": 3,
                          "copenerf.view.fetch": 1, "copenerf.render": 3,
                          "copenerf.render.importance": 3,
                          "copenerf.render.core": 3}
    assert {parent_of(log, i) for i, e in enumerate(log)
            if e[0] == "copenerf.render"} == {"copenerf.view.chunk"}
    image = torch.rand(3, H, W)
    ones = torch.ones(16, 1)
    with P.record_spans() as log:
        loss, _ = pose_loss(fields, tr.rcfg, torch.zeros(3), torch.zeros(3),
                            torch.eye(4), image, torch.from_numpy(k),
                            torch.arange(16), torch.tensor(0.0), ones * 0.5,
                            ones * 3.5, generator=torch.Generator())
    assert torch.isfinite(loss)
    assert names(log)["copenerf.pose.loss"] == 1
    assert [parent_of(log, i) for i, e in enumerate(log)
            if e[0] == "copenerf.render"] == ["copenerf.pose.loss"]


def test_spans_change_nothing_computed(scene, tmp_path):
    runs = []
    for on in (False, True):
        tr = trainer(scene, tmp_path / str(on))
        with P.record_spans() if on else P.span("copenerf.off"):
            losses = run_steps(tr, stage1=True, n=2)
        params = {k: p.detach().clone()
                  for k, p in tr.state["fields"].named_parameters()}
        runs.append((torch.stack(losses), params))
    (loss_off, off), (loss_on, on) = runs
    assert torch.equal(loss_off, loss_on)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_the_trainer_profile_window_shows_the_spans(scene, tmp_path):
    # Five train views, one epoch: iterations 0-4 profiled, visualizations
    # at 0, 2 and 4.
    tr = trainer(scene, tmp_path, profile_trace_at_it=0,
                 depth_bound_update_every_milestones=[2, 0, 0])
    tr.train(max_epochs=1)
    with open(tr.profile_summary["trace"]) as f:
        events = json.load(f)["traceEvents"]
    found = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    assert found["copenerf.step"] == 5
    assert found["copenerf.visualize"] == 3
    assert found["copenerf.render"] >= 5
    assert tr.profile_summary["wall_ms_outside"] < \
        tr.profile_summary["wall_ms"]
