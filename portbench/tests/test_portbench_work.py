"""Operation and byte counts at the published widths against hand counts,
and the arithmetic of the metric readers on known inputs."""

from __future__ import annotations

import types

import pytest

from portbench import trace, work
from portbench.metrics import _common
from portbench.run import load_json, reader

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
    assert t.kernel_runs_s(_common.K1_FWD) == pytest.approx(5e-6)
    # A reduction with no row kernel before it belongs to no backward.
    assert t.kernel_runs_s(_common.K1_BWD, _common.WGRAD) == 0.0
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


# ---------------------------------------------------------------------------
# Kernel families by name and stream order (Trace.kernel_runs_s)
# ---------------------------------------------------------------------------

NS = "void copenerf::"
WG_PARTIAL = NS + "wgrad_wg_partial_kernel<(copenerf::TcVariant)1>(copenerf::WgradArgs, float*)"
WG_FINAL = NS + "wgrad_final_kernel(copenerf::WgradArgs, float const*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)"

# A train step's kernels on one stream, in order: (name, duration, the host
# range that launches it eagerly). Durations are distinct powers of two, so
# each sum names its kernels.
STEP = [
    (NS + "sdf_value_kernel(float const*)", 1, None),                  # K2
    (NS + "rendercore_fwd_kernel<false>(float const*)", 2,
     "copenerf.kernel.rendercore_fwd"),
    (NS + "sdf_value_kernel(float const*)", 4, None),                  # K3-fwd
    (FILL, 8, "SdfValueDiffBackward"),
    (NS + "sdf_value_bwd_kernel(float const*)", 16, "SdfValueDiffBackward"),
    (WG_PARTIAL, 32, "SdfValueDiffBackward"),
    (WG_FINAL, 64, "SdfValueDiffBackward"),
    (FILL, 128, "RenderCoreBackward"),
    (NS + "rendercore_bwd_kernel<false>(float const*)", 256,
     "RenderCoreBackward"),
    (WG_PARTIAL, 512, "RenderCoreBackward"),
    (WG_FINAL, 1024, "RenderCoreBackward"),
    ("void at::native::unrolled_elementwise_kernel<copy>(int)", 2048,
     "RenderCoreBackward"),
    # K6 and K7 with their own reductions: neither K1 nor K3.
    (NS + "rendercore_fwd_kernel<true>(float const*)", 4096, None),
    (NS + "rendercore_bwd_kernel<true>(float const*)", 8192, None),
    (WG_PARTIAL, 16384, None),
    (NS + "sdf_out_bwd_kernel(float const*)", 32768, None),
    (WG_PARTIAL, 65536, None),
    (WG_FINAL, 131072, None),
]
K1_BWD_US = 256 + 512 + 1024
K3_BWD_US = 16 + 32 + 64
STREAM = 7


def _step_events(launch):
    """The window, the host ranges and STEP's kernels back to back on one
    stream, each launched by the host inside its range (``eager``) or all
    by one ``cudaGraphLaunch`` outside any range (``graph``)."""
    events = [_ev("user_annotation", trace.WINDOW, 0, 10 ** 7)]
    ts, dev_ts = 10, 1000
    if launch == "graph":
        events.append(_ev("cuda_runtime", "cudaGraphLaunch", ts, 5,
                          correlation=1))
    for i, (name, dur, rng) in enumerate(STEP):
        corr = 1 if launch == "graph" else 100 + i
        if launch == "eager":
            if rng:
                events.append(_ev("cpu_op" if "Backward" in rng
                                  else "user_annotation", rng, ts, 4, tid=2))
            events.append(_ev("cuda_runtime", "cudaLaunchKernel", ts + 1, 1,
                              tid=2, correlation=corr))
        events.append(_ev("kernel", name, dev_ts, dur, tid=STREAM,
                          correlation=corr, stream=STREAM, device=0))
        ts, dev_ts = ts + 10, dev_ts + dur + 3
    return events


def _run(t, kind):
    return types.SimpleNamespace(kind=kind, trace=t, units=1,
                                 rays_per_unit=1024, cfg=CFG, window_s=1.0,
                                 plain_s=1.0, mix={})


ROOFLINES = [("k1_bwd_roofline_pct.train", "train"),
             ("k1_bwd_roofline_pct.eval_pose", "eval_pose"),
             ("k1_fwd_roofline_pct.train", "train"),
             ("k3_bwd_roofline_pct.train", "train"),
             ("k1_fwd_roofline_pct.render", "render"),
             ("k2_roofline_pct.render", "render")]


@pytest.mark.parametrize("name, kind", ROOFLINES)
def test_a_roofline_reads_alike_launched_eagerly_or_by_a_graph(name, kind):
    eager = reader(name)(_run(trace.Trace(_step_events("eager"), 1.0), kind))
    graph = reader(name)(_run(trace.Trace(_step_events("graph"), 1.0), kind))
    assert eager is not None and 0 < eager
    assert graph == eager


def test_each_backward_takes_the_reduction_that_follows_it():
    t = trace.Trace(_step_events("graph"), 1.0)
    # K3-bwd's reduction is not K1-bwd's, though named alike; the fills and
    # the unpack around a row kernel belong to neither.
    assert t.kernel_runs_s(_common.K3_BWD, _common.WGRAD) == \
        pytest.approx(K3_BWD_US * 1e-6)
    assert t.kernel_runs_s(_common.K1_BWD, _common.WGRAD) == \
        pytest.approx(K1_BWD_US * 1e-6)
    # K1-fwd is <false> alone (not K6-fwd); K2's name is K3-fwd's too.
    assert t.kernel_runs_s(_common.K1_FWD) == pytest.approx(2e-6)
    assert t.kernel_runs_s(_common.K2) == pytest.approx(5e-6)
    run = _run(t, "train")
    flop, nbytes = work.k3_bwd_work(CFG, 1024 * work.samples(CFG))
    assert reader("k3_bwd_roofline_pct.train")(run) == pytest.approx(
        100 * work.roofline_s(flop, nbytes) / (K3_BWD_US * 1e-6))


def test_k6_and_k7_count_for_neither_backward():
    keep = [(n, d, r) for n, d, r in STEP
            if "<true>" in n or "sdf_out_bwd" in n or d > 4096]
    events = [_ev("kernel", n, 1000 * i, d, stream=STREAM, device=0)
              for i, (n, d, _) in enumerate(keep)]
    t = trace.Trace(events, 1.0)
    for lead in (_common.K1_BWD, _common.K3_BWD, _common.K1_FWD):
        assert t.kernel_runs_s(lead, _common.WGRAD) == 0.0
    for name, kind in ROOFLINES:
        assert reader(name)(_run(t, kind)) is None


def test_a_trace_without_the_kernels_reads_nothing():
    events = [_ev("kernel", FILL, 10, 5, stream=STREAM, device=0),
              _ev("kernel", WG_PARTIAL, 20, 5, stream=STREAM, device=0)]
    for t in (trace.Trace([], 1.0), trace.Trace(events, 1.0)):
        for name, kind in ROOFLINES:
            assert reader(name)(_run(t, kind)) is None


def test_two_streams_do_not_merge_runs():
    bwd = NS + "rendercore_bwd_kernel<false>(float const*)"
    events = [
        _ev("kernel", bwd, 0, 10, stream=7, device=0),
        # Another stream's reduction starts between K1-bwd and its own.
        _ev("kernel", WG_PARTIAL, 12, 100, stream=8, device=0),
        _ev("kernel", WG_PARTIAL, 20, 3, stream=7, device=0),
        _ev("kernel", WG_FINAL, 30, 1, stream=7, device=0),
        # The same stream number on another card is another stream.
        _ev("kernel", WG_FINAL, 40, 1000, stream=7, device=1),
    ]
    t = trace.Trace(events, 1.0)
    assert t.kernel_runs_s(_common.K1_BWD, _common.WGRAD) == \
        pytest.approx(14e-6)


def test_a_kernels_own_name():
    assert trace.base(WG_PARTIAL) == "wgrad_wg_partial_kernel"
    assert trace.base(WG_FINAL) == "wgrad_final_kernel"
    assert trace.base(FILL) == "vectorized_elementwise_kernel"
    assert trace.base("void (anonymous namespace)::k<1>(int)") == "k"
