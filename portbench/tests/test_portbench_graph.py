"""On the card: the kernel rooflines read a CUDA graph's replay of the
port's K1 and K3, forward and backward, as they read the same kernels
launched eagerly; the host-range attribution that they used before reads
nothing on the replay.

    python -m pytest --noconftest -m gpu portbench/tests/test_portbench_graph.py
"""

from __future__ import annotations

import types

import pytest

from portbench import trace, work
from portbench.drivers._common import program_cfg
from portbench.run import load_json, reader

CFG = load_json("portbench", "configs", "tanks_family.json")
RAYS = load_json("portbench", "traffic", "train_s1.json")["rays"]
REPS = 3

# (metric, the traffic kind it reads, the host range it read before)
ROOFLINES = [
    ("k1_bwd_roofline_pct.train", "train", "RenderCoreBackward"),
    ("k1_bwd_roofline_pct.eval_pose", "eval_pose", "RenderCoreBackward"),
    ("k1_fwd_roofline_pct.train", "train", "copenerf.kernel.rendercore_fwd"),
    ("k3_bwd_roofline_pct.train", "train", "SdfValueDiffBackward"),
    ("k1_fwd_roofline_pct.render", "render", None),
    ("k2_roofline_pct.render", "render", "copenerf.kernel.sdf_value"),
]


def launched_under(t, name) -> float:
    """Device seconds of the kernels whose launch lies inside a host range
    named ``name`` on the launching thread: the attribution by host range
    that a replay defeats."""
    total = 0.0
    for e in t.kernels:
        where = t.launch.get(e.get("args", {}).get("correlation"))
        if where and any(a <= where[2] <= b and n == name
                         for a, b, n in t.host.get(where[:2], [])):
            total += float(e["dur"])
    return total * 1e-6


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name()


@pytest.mark.gpu
def test_rooflines_read_a_graph_replay_as_its_eager_launches(card):
    import torch

    from copenerf_torch.models.fields import (configs_from_cfg,
                                              init_all_fields,
                                              sdf_grad_color_cons,
                                              sdf_value_nograd)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    fields = init_all_fields(configs_from_cfg(program_cfg(CFG)),
                             torch.Generator().manual_seed(0), device=dev)
    sdf, color = fields["sdf"], fields["color"]
    params = [*sdf.parameters(), *color.parameters()]
    # The train_s1 step's shapes: its swept points (K2) and its samples
    # (K1, and K3 at the consistency's transformed points).
    n, m = RAYS * work.samples(CFG), RAYS * work.sweep_points(CFG)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    x, y, swept = rand(n, 4), rand(n, 4), rand(m, 4)
    dirs = torch.nn.functional.normalize(rand(n, 3), dim=-1)
    cots = [rand(n, 1), rand(n, 4), rand(n, 3), rand(n)]

    def step():
        with torch.no_grad():
            sdf_value_nograd(sdf, swept)
        outs = sdf_grad_color_cons(sdf, color, x, dirs, y)
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(loss, params)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()

    with trace.capture(dev) as eager:
        for _ in range(REPS):
            step()
    with trace.capture(dev) as replay:
        for _ in range(REPS):
            graph.replay()
    eager, replay = eager["trace"], replay["trace"]
    assert replay.kernels, "the profiler recorded no kernel of the replay"

    def run(t, kind):
        return types.SimpleNamespace(kind=kind, trace=t, units=REPS,
                                     rays_per_unit=RAYS, cfg=CFG)

    readings = {}
    for name, kind, old in ROOFLINES:
        a, b = reader(name)(run(eager, kind)), reader(name)(run(replay, kind))
        readings[name] = (a, b)
        assert a is not None and b is not None, (name, a, b)
        assert 0 < a < 100 and abs(b - a) <= 0.02 * a, (name, a, b)
        if old:
            assert launched_under(eager, old) > 0, old
            assert launched_under(replay, old) == 0, old
    print(card, {k: [round(v, 4) for v in ab] for k, ab in readings.items()})
