"""The readers of the program's spans on known inputs: a synthetic profiled
stretch (idle split by overlap, a kernel under a kernel span, a thread
with no span of its own, a sync, time outside the program), a synthetic
spans log, and every new reader returning None where it finds nothing."""

from __future__ import annotations

import types

import pytest

from portbench import spans, trace
from portbench.run import load_json, reader

CFG = load_json("portbench", "configs", "tanks_family.json")
MAIN, AUTOGRAD = 1, 2


def _ev(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _launch(ts, corr, tid=MAIN):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
               correlation=corr)


EVENTS = [
    _ev("user_annotation", trace.WINDOW, 0, 100),
    _ev("user_annotation", "copenerf.step", 5, 90),
    _ev("user_annotation", "copenerf.step.motion", 10, 20),
    _ev("cpu_op", "aten::mm", 11, 3),
    _ev("user_annotation", "copenerf.kernel.rendercore_fwd", 32, 4),
    _ev("user_annotation", "copenerf.step.backward", 40, 40),
    # The autograd engine's thread: a kernel span, then a launch in none.
    _ev("user_annotation", "copenerf.kernel.rendercore_bwd", 50, 10,
        tid=AUTOGRAD),
    _launch(12, 1), _launch(33, 2), _launch(55, 3, AUTOGRAD),
    _launch(75, 4, AUTOGRAD), _launch(85, 5), _launch(97, 6),
    _ev("kernel", "void mm_kernel()", 20, 5, correlation=1),
    _ev("kernel", "void rendercore_fwd_kernel<false>()", 35, 3,
        correlation=2),
    _ev("kernel", "void rendercore_bwd_kernel<false>()", 60, 10,
        correlation=3),
    _ev("kernel", "void add_kernel()", 76, 2, correlation=4),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 86, 1,
        correlation=5),
    _ev("kernel", "void fill_kernel()", 98, 1, correlation=6),
]


def _run(events=EVENTS, **kw):
    t = trace.Trace(events, wall_s=100e-6)
    fields = dict(kind="train", trace=t, units=2, plain_s=100e-6,
                  window_s=100e-6, rays_per_unit=1, cfg=CFG,
                  mix={"trace_units": 2})
    fields.update(kw)
    return types.SimpleNamespace(**fields)


def test_timeline_nests_and_cuts_overhanging_ranges():
    line = spans.timeline([(0, 10, "a"), (2, 4, "b"), (3, 12, "c"),
                           (20, 30, "d")])
    assert line == [(0, 2, ("a",)), (2, 3, ("b", "a")),
                    (3, 4, ("c", "b", "a")), (4, 10, ("a",)),
                    (20, 30, ("d",))]


def test_idle_is_split_over_the_innermost_spans_by_overlap():
    lay = spans.Layers(trace.Trace(EVENTS, wall_s=100e-6))
    rows = lay.by_span()
    idle = {k: pytest.approx(v["idle_s"] * 1e6) for k, v in rows.items()
            if v["idle_s"]}
    # Gaps 0-20, 25-35, 38-60, 70-76, 78-86, 87-98, 99-100: 38-50 ends at a
    # launch of the autograd thread outside its spans, so falls to the
    # window's thread; 50-60 to the kernel span open there.
    assert idle == {spans.OUTSIDE: 9, "copenerf.step": 23,
                    "copenerf.step.motion": 15,
                    "copenerf.kernel.rendercore_fwd": 3,
                    "copenerf.step.backward": 18,
                    "copenerf.kernel.rendercore_bwd": 10}
    assert sum(v["idle_s"] for v in rows.values()) == pytest.approx(78e-6)
    assert lay.glue_idle_share() == pytest.approx(56 / 78)


def test_kernels_and_syncs_count_under_every_span_around_their_launch():
    rows = spans.Layers(trace.Trace(EVENTS, wall_s=100e-6)).by_span()
    step = rows["copenerf.step"]
    assert step["launches"] == 4 and step["syncs"] == 1
    assert step["device_s"] == pytest.approx(20e-6)
    assert rows["copenerf.step.backward"]["launches"] == 2
    assert rows["copenerf.kernel.rendercore_bwd"]["device_s"] == \
        pytest.approx(10e-6)
    assert rows["copenerf.step.motion"]["launches"] == 1
    assert rows[spans.OUTSIDE]["launches"] == 1
    assert rows[spans.OUTSIDE]["syncs"] == 0


def test_copies_that_wait_for_the_card_are_syncs():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("user_annotation", "copenerf.step", 5, 90),
        _launch(10, 1), _launch(20, 2), _launch(30, 3), _launch(40, 4),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 12, 1,
            correlation=1),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 22, 1,
            correlation=2),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 32, 1,
            correlation=3),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 42, 1,
            correlation=4),
    ]
    rows = spans.Layers(trace.Trace(events, wall_s=100e-6)).by_span()
    assert rows["copenerf.step"]["syncs"] == 2
    assert rows["copenerf.step"]["launches"] == 0


def test_the_device_readers_on_the_synthetic_stretch():
    run = _run()
    # 78% idle over the untraced stretch, 56 of its 78 us in the glue.
    assert reader("glue_idle_pct.train")(run) == pytest.approx(56.0)
    assert reader("host_syncs_per_step.train")(run) == 0.5
    assert reader("k1_fwd_roofline_pct.train")(run) > 0


LOG = [  # (name, thread, start_ns, end_ns, parent)
    ("copenerf.step.motion", 1, 10, 30, 3),
    ("copenerf.render.core", 1, 40, 60, 2),
    ("copenerf.render", 1, 35, 70, 3),
    ("copenerf.step", 1, 5, 95, None),
    ("copenerf.kernel.rendercore_bwd", 2, 80, 85, 3),
    ("copenerf.render", 1, 110, 120, 6),
    ("copenerf.view", 1, 100, 125, None),
]


def test_host_table_and_ancestry_of_a_spans_log():
    table = spans.host_table(LOG, wall_ns=130)
    assert table["copenerf.step"] == {"count": 1, "incl_ns": 90,
                                      "self_ns": 90 - 20 - 35 - 5}
    assert table["copenerf.render"] == {"count": 2, "incl_ns": 45,
                                        "self_ns": 45 - 20}
    assert table[spans.OUTSIDE]["self_ns"] == 130 - 90 - 25
    assert sum(r["self_ns"] for r in table.values()) == 130
    assert spans.under(LOG, "copenerf.render", "copenerf.step") == 35
    assert spans.under(LOG, "copenerf.render", "copenerf.view") == 10


def test_host_readers_read_the_spans_stretch(capsys):
    run = _run()
    run.__dict__["_spans_stretch"] = {
        "log": LOG, "units": 2, "spans_ns": 130, "plain_ns": 125,
        "table": spans.host_table(LOG, 130)}
    assert reader("motion_host_ms.train")(run) == pytest.approx(10e-6)
    assert reader("render_host_ms.train")(run) == pytest.approx(17.5e-6)
    assert reader("backward_host_ms.train")(run) is None
    err = capsys.readouterr().err
    assert "spans on: +0.0400" in err and "copenerf.step.motion" in err
    assert "idle in program spans: 88.5% of 0.078 ms" in err


def test_the_backward_leaves_out_the_host_side_of_its_kernels():
    log = [  # the autograd thread's kernel spans hang from the backward
        ("copenerf.kernel.rendercore_bwd", 2, 20, 60, 2),
        ("copenerf.kernel.sdf_value_bwd", 2, 70, 75, 2),
        ("copenerf.step.backward", 1, 10, 90, 3),
        ("copenerf.step", 1, 0, 100, None),
    ]
    run = _run()
    run.__dict__["_spans_stretch"] = {
        "log": log, "units": 1, "spans_ns": 100, "plain_ns": 100,
        "table": spans.host_table(log, 100)}
    assert spans.under(log, spans.KERNEL, "copenerf.step.backward",
                       prefix=True) == 45
    assert reader("backward_host_ms.train")(run) == pytest.approx(35e-6)


def run_cell(seed, device):
    # Stands in for portbench/run.py's run_cell, whose frame the spans
    # stretch reads the run's seed and device from.
    return spans.cell_call()


run_cell.__code__ = run_cell.__code__.replace(
    co_filename=spans.os.path.join(spans.ROOT, "portbench", "run.py"))


def test_the_stretch_reads_its_seed_and_device_from_the_run():
    assert run_cell(2147483901, "cuda") == (2147483901, "cuda")
    with pytest.raises(RuntimeError, match="run_cell"):
        spans.cell_call()


def test_a_stretch_that_fails_fails_the_run(monkeypatch):
    calls = []

    def fake(cmd, **kw):
        calls.append((cmd, kw))
        return types.SimpleNamespace(returncode=1, stdout="")

    monkeypatch.setattr(spans.subprocess, "run", fake)
    monkeypatch.setattr(spans, "cell_call", lambda: (7, "cpu"))
    with pytest.raises(RuntimeError, match="exited with 1"):
        spans.stretch(_run())
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "portbench.spans", "--stdin"]
    request = spans.json.loads(kw["input"])
    assert (request["seed"], request["device"]) == (7, "cpu")
    assert request["mix"] == {"trace_units": 2}


@pytest.mark.parametrize("metric", [
    "motion_host_ms.train", "losses_host_ms.train", "render_host_ms.train",
    "backward_host_ms.train", "optimizer_host_ms.train",
    "glue_idle_pct.train", "host_syncs_per_step.train",
    "k1_fwd_roofline_pct.train", "k2_roofline_pct.render",
    "render_host_ms.eval_pose"])
def test_readers_return_nothing_where_nothing_was_read(metric, monkeypatch):
    read = reader(metric)
    kind = metric.split(".")[1]
    # No trace; a trace of a program without spans, which makes no spans
    # stretch.
    monkeypatch.setattr(spans.subprocess, "run", None)
    assert read(_run(trace=None, kind=kind)) is None
    bare = [e for e in EVENTS if not e["name"].startswith("copenerf.")]
    run = _run(bare, kind=kind)
    if "roofline" in metric:
        # A roofline finds its kernels by name, with spans or without: it
        # reads K1-fwd here, and has nothing to read where no kernel is.
        assert (read(run) is not None) == (metric.startswith("k1_fwd"))
        bare = [e for e in bare if e["cat"] != "kernel"]
        run = _run(bare, kind=kind)
    assert read(run) is None
    assert not spans.has_spans(run)
    assert spans.stretch(run) is None and spans.layers(run) is None
