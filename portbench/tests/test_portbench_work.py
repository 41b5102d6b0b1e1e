"""Operation and byte counts at the published widths against hand counts,
and the arithmetic of the metric readers on known inputs."""

from __future__ import annotations

import types

import pytest

from portbench import trace, work
from portbench.metrics import _common
from portbench.run import load_json

CFG = load_json("portbench", "configs", "tanks_family.json")

# Hand counts of multiply-adds per row at the published widths.
# SDF: 52->256, 256->256, 256->256, 256->204 (feeds the skip), 256->256 x4.
H = 52 * 256 + 2 * 256 * 256 + 256 * 204 + 4 * 256 * 256     # 458,752
# Color: 291 (4 points + 27 encoded dirs + 4 normals + 256 feature) -> 256,
# 256 -> 256 x3, 256 -> 3.
C = 291 * 256 + 3 * 256 * 256 + 256 * 3                          # 271,872
F = 256 * 256                                                    # feature


def test_hand_counts_of_the_shapes():
    sh = work.Shapes.of(CFG)
    assert (sh.sdf_hidden, sh.color, sh.feature) == (H, C, F)
    assert (H, C) == (458_752, 271_872)
    # Motion: 13 -> 256, 256 -> 243 (feeds the skip), 256 -> 256 x2, 256 -> 6.
    assert sh.motion == 13 * 256 + 256 * 243 + 2 * 256 * 256 + 256 * 6


@pytest.mark.parametrize("fn, macs, row_bytes", [
    (work.k2_work, H + 256, 20),
    (work.k1_fwd_work, (H + 256 * 257) + (256 + H + 52 * 4) + C, 60),
])
def test_forward_counts(fn, macs, row_bytes):
    n = 131_072
    flop, nbytes = fn(CFG, n)
    assert flop == 2 * macs * n
    assert nbytes - row_bytes * n == work.weight_bytes(
        CFG, ("sdf",) if fn is work.k2_work else ("sdf", "color"))


def test_k1_bwd_counts_no_recomputed_forward():
    n = 131_072
    data = 2 * H + F + 256 + C          # tangent sweep up, backprop down
    wgrad = 2 * H + 256 * 257 + 256 + C
    assert work.k1_bwd_work(CFG, n)[0] == 2 * (data + wgrad) * n
    assert work.k1_bwd_work(CFG, n, weight_grads=False)[0] == 2 * data * n
    assert data + wgrad == 2_510_592
    flop, nbytes = work.k1_bwd_work(CFG, n)
    assert nbytes == 88 * n + 2 * work.weight_bytes(CFG)


def test_render_chunk_and_peaks():
    # 32,768 rays: 112 swept points and 128 render-core points a ray.
    assert work.sweep_points(CFG) == 112 and work.samples(CFG) == 128
    flop = work.render_flop(CFG, 32_768)
    assert flop == 2 * 32_768 * (112 * (H + 256) + 128 * 1_255_632)
    assert 13.8e12 < flop < 14.0e12
    assert work.TF32_PEAK == 495e12 and work.HBM_RATE == 3.35e12
    assert work.roofline_s(495e12, 0) == 1.0
    assert work.roofline_s(0, 3.35e12) == 1.0


def test_train_step_counts_the_stage_1_parts():
    s1 = work.train_step_flop(CFG, 1024, True, True, 100)
    s2 = work.train_step_flop(CFG, 1024, False, False, 100)
    n = 1024 * 128
    assert s1 - s2 == (work.k2_work(CFG, n)[0] + work.k3_bwd_work(CFG, n)[0]
                       + work.motion_flop(CFG, 99 * 10 + 1, True))


def test_p95_by_nearest_rank():
    assert _common.p95_ms(list(range(1, 101))) == 95
    assert _common.p95_ms([5.0]) == 5.0
    assert _common.p95_ms(list(range(1, 21))) == 19
    assert _common.p95_ms([]) is None


def test_union_and_gaps_of_spans():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.union_s(spans) == pytest.approx(25e-6)
    assert trace.gaps(spans, 0, 40) == [(15, 20), (30, 40)]
    assert trace.gaps(spans, -5, 12) == [(-5, 0)]


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def test_trace_attributes_kernels_by_the_range_that_launched_them():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("cpu_op", "RenderCoreBackward", 10, 20, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, tid=2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, tid=2, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, tid=1, correlation=3),
        _ev("kernel", "void wgrad_wg_partial_kernel(float*)", 50, 10,
            correlation=1),
        _ev("kernel", "void wgrad_wg_partial_kernel(float*)", 62, 8,
            correlation=2),
        _ev("kernel", "void rendercore_fwd_kernel<false>(float*)", 15, 5,
            correlation=3),
    ]
    t = trace.Trace(events, wall_s=100e-6)
    assert t.kernel_s_under(["RenderCoreBackward"]) == pytest.approx(10e-6)
    assert t.kernel_s_named(["rendercore_fwd_kernel<false>"]) == \
        pytest.approx(5e-6)
    assert t.busy_s == pytest.approx(23e-6)
    assert t.launches == 3
    assert t.top_ops()[0] == ["wgrad_wg_partial_kernel", pytest.approx(18e-6)]
    # Idle: 0-15, 20-50, 60-62, 70-100; the gaps before the first two
    # kernels end at launches inside no range / inside RenderCoreBackward.
    gaps = dict(t.top_gaps())
    assert gaps["host: portbench.window"] == pytest.approx(15e-6)
    assert gaps["host: RenderCoreBackward"] == pytest.approx(30e-6)
    assert gaps["host: end of window"] == pytest.approx(30e-6)


def test_readers_return_nothing_where_nothing_was_read():
    run = types.SimpleNamespace(kind="render", trace=None, window_s=1.0, plain_s=None,
                                units=1, rays_per_unit=10, cfg=CFG, mix={})
    assert _common.mfu_pct(run, "render") is None
    assert _common.k1_bwd_pct(run, "train", True) is None
    empty = trace.Trace([], wall_s=1.0)
    run.trace = empty
    assert _common.roofline_pct(run, 1.0, 1.0, 0.0) is None
    assert _common.rate(run, "train") is None
