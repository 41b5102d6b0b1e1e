"""The port's CUDA kernels on the card, held against their plain PyTorch
versions. Marked ``gpu``: each test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so on the H100 (which has no JAX) it
runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 in both versions, summed in another order; sdf and color
1e-4 absolute, grad 1e-4 x max(1, max|grad|). Backward kernels (gradients
of x, dirs and every parameter) are held against an f64 evaluation of the
plain version: per tensor the kernel's error norm is at most twice the plain
f32 version's, or 1e-5 of the tensor's scale (its norm; with every cotangent
on, the sum of its norms for each one alone). The color cotangent is zeroed
on rows where a color ReLU's pre-activation lies within KINK_MARGIN of 0 in
f64 (f32 rounding moves those pre-activations by up to ~2e-6 at full width,
and a ReLU that flips in one f32 version and not the other moves its row's
gradients by far more than rounding). The nets are the geometric init
perturbed by ``perturb_``, so the PE columns are not zero and the SDF head's
columns differ: a fault in the PE or in the column order shows. The
composed path's kernels (K4 outgrad, K5 color), the folded render core (K6)
and the SDF output (K7) are held to the same rules; K4's and K7's head
outputs and K6's sdf_w, like sdf, to 1e-4 absolute."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from copenerf_torch.evaluation.render import ImageRenderer
from copenerf_torch.models import fields as TF
from copenerf_torch.models.mlp import perturb_
from copenerf_torch.ops.kernels import color as CK
from copenerf_torch.ops.kernels import outgrad as OG
from copenerf_torch.ops.kernels import rendercore as RC
from copenerf_torch.ops.kernels import rendercore_cons as RCC
from copenerf_torch.ops.kernels import sdf_out as SO
from copenerf_torch.ops.kernels import sdf_value as SV
from copenerf_torch.ops.kernels import sdf_value_diff as SVD
from copenerf_torch.ops.renderer import RendererConfig
from copenerf_torch.training import step as TS

WIDTHS = {
    "full": (TF.SDFConfig(), TF.ColorConfig()),
    "small": (TF.SDFConfig(d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                           multires=3),
              TF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                             multires_view=2)),
}
KINK_MARGIN = 2e-5


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the H100)")


def _nets(width, device):
    scfg, ccfg = WIDTHS[width]
    nets = (TF.SDFNetwork(scfg, torch.Generator().manual_seed(0)),
            TF.ColorNetwork(ccfg, torch.Generator().manual_seed(1)))
    g = torch.Generator().manual_seed(2)
    return tuple(perturb_(net, g).to(device) for net in nets)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, size=(n, 4)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(x).cuda(), torch.from_numpy(d).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_kernels_match_plain_on_card(width, n):
    _require_cuda()
    sdf_net, color_net = _nets(width, "cuda")
    x, d = _rows(n, seed=n)
    with torch.no_grad():
        v = SV.sdf_value_cuda(sdf_net, x)
        torch.testing.assert_close(v, SV.sdf_value_plain(sdf_net, x),
                                   rtol=0, atol=1e-4)
        got = RC.rendercore_fwd_cuda(sdf_net, color_net, x, d)
        ref = RC.rendercore_fwd_plain(sdf_net, color_net, x, d)
    for name, g, r in zip(("sdf", "grad", "color"), got, ref):
        tol = 1e-4 * (max(1.0, r.abs().max().item()) if name == "grad" else 1)
        torch.testing.assert_close(g, r, rtol=0, atol=tol, msg=name)


@pytest.mark.gpu
def test_kernels_refuse_grad_mode_on_card():
    """The raw forward launchers refuse weights that require grad under
    grad mode; ``sdf_grad_color`` and ``sdf_scalar`` under grad reach the
    autograd.Functions, whose backward is a kernel."""
    _require_cuda()
    sdf_net, color_net = _nets("small", "cuda")
    x, d = _rows(8, seed=0)
    with pytest.raises(RuntimeError, match="forward-only"):
        SV.sdf_value_cuda(sdf_net, x)
    with pytest.raises(RuntimeError, match="forward-only"):
        RC.rendercore_fwd_cuda(sdf_net, color_net, x, d)
    counters = (RC.COUNTER, RC.BWD_COUNTER, SVD.FWD_COUNTER, SVD.BWD_COUNTER)
    before = [c.launches for c in counters]
    sdf, grad, color = TF.sdf_grad_color(sdf_net, color_net, x, d)
    value = TF.sdf_scalar(sdf_net, x)
    (sdf.sum() + grad.square().sum() + color.sum() + value.sum()).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    assert all(p.grad is not None for p in sdf_net.parameters())


def _check_vs_f64(got, plain, ref64, what, scales=None):
    """Per tensor ||kernel - f64|| <= max(2 ||plain - f64||, 1e-5 scale);
    the scale is the f64 tensor's norm, or ``scales[i]``."""
    for i, (a, b, c) in enumerate(zip(got, plain, ref64)):
        c = c.float()
        scale = scales[i] if scales else c.norm().item()
        e_k = (a - c).norm().item()
        e_p = (b - c).norm().item()
        assert e_k <= max(2 * e_p, 1e-5 * scale), (what, i, e_k, e_p, scale)


def _grads(fn, inputs, params, cots):
    for p in params:
        p.grad = None
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    torch.autograd.backward(out, cots)
    return [t.grad for t in ins] + [p.grad.clone() for p in params]


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_backward_kernels_match_plain_on_card(width, n):
    """K1-bwd and K3-bwd (through their autograd.Functions) against
    autograd of the plain versions on the same card: x_bar, dirs_bar and
    the gradients of every parameter of both nets, for each cotangent alone
    and all together. With all on, a tensor's scale is the sum of its norms
    for each cotangent alone: an f32 sum is exact to the rounding of its
    terms, and in the SDF head's g the channels cancel to a thirtieth."""
    _require_cuda()
    sdf_net, color_net = _nets(width, "cuda")
    params = [*sdf_net.parameters(), *color_net.parameters()]
    x, d = _rows(n, seed=n + 7)
    g = torch.Generator(device="cuda").manual_seed(n)
    full = [torch.randn((n, w), generator=g, device="cuda") for w in (1, 4, 3)]
    sdf64, color64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    margin = RC.color_relu_margin(sdf64, color64, x.double(), d.double())
    full[2] = full[2] * (margin >= KINK_MARGIN).float()[:, None]
    norms = []
    for on in ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)):
        cots = [c * m for c, m in zip(full, on)]
        got = _grads(lambda a, b: RC.rendercore_fwd(sdf_net, color_net, a, b),
                     (x, d), params, cots)
        ref = _grads(lambda a, b: RC.rendercore_fwd_plain(sdf_net, color_net, a, b),
                     (x, d), params, cots)
        ref64 = _grads(lambda a, b: RC.rendercore_fwd_plain(sdf64, color64, a, b),
                       (x.double(), d.double()),
                       [*sdf64.parameters(), *color64.parameters()],
                       [c.double() for c in cots])
        scales = [sum(t) for t in zip(*norms)] if sum(on) == 3 else None
        norms.append([c.norm().item() for c in ref64])
        _check_vs_f64(got, ref, ref64, f"K1 {on}", scales)
    obar = torch.randn((n,), generator=g, device="cuda")
    sp = list(sdf_net.parameters())
    got = _grads(lambda a: SVD.sdf_value_diff(sdf_net, a), (x,), sp, [obar])
    ref = _grads(lambda a: SVD.sdf_value_diff_plain(sdf_net, a), (x,), sp,
                 [obar])
    ref64 = _grads(lambda a: SVD.sdf_value_diff_plain(sdf64, a), (x.double(),),
                   list(sdf64.parameters()), [obar.double()])
    _check_vs_f64(got, ref, ref64, "K3")


@pytest.mark.gpu
def test_train_step_card_matches_cpu():
    """One stage-1 step at a small width, 64 rays, injected ray_idx and
    t_rand, on the card (kernels) and on the CPU (plain versions): every
    metric within 1e-4 relative + 1e-5, every parameter gradient within
    1e-3 of its tensor's largest entry."""
    _require_cuda()
    h = w = 24
    f = 60.0
    K = torch.tensor([[2 * f / w, 0, 0, 0], [0, -2 * f / h, 0, 0],
                      [0, 0, -1, 0], [0, 0, 0, 1]])
    world = torch.eye(4)
    world[2, 3] = -2.5
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    imgs = torch.stack([torch.stack([0.5 + 0.4 * torch.sin(0.25 * xx + 0.2 * (c + 1) * yy
                                                           + 0.3 * t + c)
                                     for c in range(3)]) for t in range(7)])
    g = torch.Generator().manual_seed(0)
    idx = TS.sample_patch_indices(g, h, w, 4, 64, device="cpu")
    t_rand = torch.rand((64, 16), generator=g)
    scfg, ccfg = WIDTHS["small"]
    s = TS.StepStatic(h=h, w=w, patch_size=4, n_points=64, stage1=True,
                      n_images=7, nb_sample_timestep=4, n_ref=3,
                      train_motion=True, sdf_cons_pose_grad=True,
                      use_flow_rgb=True, use_sdf_consistency=True)
    res = {}
    for dev in ("cuda", "cpu"):
        sdf_net, color_net = _nets("small", dev)
        fields = torch.nn.ModuleDict({
            "sdf": sdf_net, "color": color_net,
            "variance": TF.VarianceNetwork(TF.VarianceConfig()).to(dev),
            "motion": TF.MotionNetwork(TF.MotionConfig(d_hidden=32, n_layers=2,
                                                       skip_in=(1,)),
                                       torch.Generator().manual_seed(3)).to(dev)})
        batch = {
            "images_all": imgs.to(dev), "K_all": K.expand(7, 4, 4).to(dev),
            "ref_idxs": torch.tensor([3, 4, 5], device=dev),
            "ref_in_list": torch.ones(3, device=dev),
            "ref_valid_flow": torch.tensor([1.0, 1.0, 0.0], device=dev),
            "scale_mat": torch.eye(4, device=dev), "world_mat": world.to(dev),
            "query_time_step": torch.tensor(-0.2, device=dev),
            "world_time_step": torch.tensor(0.0, device=dev),
            "image_idx": torch.tensor(2, device=dev),
            "world_cam_idx": torch.tensor(3, device=dev),
            "near": 1.0, "far": 4.0, "cos_anneal_ratio": 0.5,
            "loss_weights": TS.make_loss_weights(1.0, 0.1, 0.1, 7.5, 0.1, 1.0,
                                                 1e-4)}
        total, metrics = TS.compute_losses(
            fields, RendererConfig(n_samples=16, n_importance=16,
                                   up_sample_steps=2), s, batch,
            idx.to(dev), t_rand=t_rand.to(dev))
        total.backward()
        res[dev] = ({k: v.item() for k, v in metrics.items()},
                    [p.grad.cpu() for k in ("sdf", "color", "variance", "motion")
                     for p in fields[k].parameters()])
    for k, v in res["cpu"][0].items():
        assert abs(res["cuda"][0][k] - v) <= 1e-4 * abs(v) + 1e-5, (k, v)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item() + 1e-6


@pytest.mark.gpu
def test_render_image_card_matches_cpu():
    """The whole render path at a small width, several chunks and a padded
    tail, on the card (kernels) and on the CPU (plain versions)."""
    _require_cuda()
    rcfg = RendererConfig(n_samples=16, n_importance=16, up_sample_steps=4)
    K = np.array([[1.6, 0, 0, 0], [0, -2.6, 0, 0], [0, 0, -1, 0],
                  [0, 0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = -2.0
    out = {}
    for dev in ("cuda", "cpu"):
        sdf_net, color_net = _nets("small", dev)
        fields = torch.nn.ModuleDict({
            "sdf": sdf_net, "color": color_net,
            "variance": TF.VarianceNetwork(TF.VarianceConfig()).to(dev)})
        out[dev] = ImageRenderer(rcfg, chunk=16, device=dev).render_image(
            fields, K, w2c, np.eye(4, dtype=np.float32), 0.1, (6, 10),
            (0.5, 4.0), 0.6)
    for k in ("color", "depth", "normal"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=0,
                                   atol=2e-3, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_composed_kernels_match_plain_on_card(width, n):
    """K4-fwd and K5-fwd (on the composed path's inputs: dirs and grad
    negated, the feature a slice of the head) against their plain versions."""
    _require_cuda()
    sdf_net, color_net = _nets(width, "cuda")
    x, d = _rows(n, seed=n + 3)
    with torch.no_grad():
        out, grad = OG.sdf_outgrad_cuda(sdf_net, x)
        ref_out, ref_grad = OG.sdf_outgrad_plain(sdf_net, x)
        torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-4)
        torch.testing.assert_close(
            grad, ref_grad, rtol=0,
            atol=1e-4 * max(1.0, ref_grad.abs().max().item()))
        ins = (x, -d, -ref_grad, ref_out[:, 1:])
        torch.testing.assert_close(CK.color_fwd_cuda(color_net, *ins),
                                   CK.color_plain(color_net, *ins), rtol=0,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_composed_backward_kernels_match_plain_on_card(width, n):
    """K4-bwd (through ``SdfOutGrad``) for the head's cotangent, the
    gradient's and both, and K5-bwd (through ``ColorMLP``) to every input
    and weight, against autograd of the plain versions and f64."""
    _require_cuda()
    sdf_net, color_net = _nets(width, "cuda")
    sdf64, color64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    x, d = _rows(n, seed=n + 11)
    g = torch.Generator(device="cuda").manual_seed(n + 1)
    full = [torch.randn((n, sdf_net.cfg.d_out), generator=g, device="cuda"),
            torch.randn((n, 4), generator=g, device="cuda")]
    sp, sp64 = list(sdf_net.parameters()), list(sdf64.parameters())
    norms = []
    for on in ((1, 0), (0, 1), (1, 1)):
        cots = [c * m for c, m in zip(full, on)]
        got = _grads(lambda a: OG.sdf_outgrad(sdf_net, a), (x,), sp, cots)
        ref = _grads(lambda a: OG.sdf_outgrad_plain(sdf_net, a), (x,), sp, cots)
        ref64 = _grads(lambda a: OG.sdf_outgrad_plain(sdf64, a), (x.double(),),
                       sp64, [c.double() for c in cots])
        scales = [sum(t) for t in zip(*norms)] if sum(on) == 2 else None
        norms.append([c.norm().item() for c in ref64])
        _check_vs_f64(got, ref, ref64, f"K4 {on}", scales)
    with torch.no_grad():
        out, grad = OG.sdf_outgrad_plain(sdf_net, x)
    ins = (x, -d, -grad, out[:, 1:].contiguous())
    margin = CK.color_relu_margin(color64, *[t.double() for t in ins])
    cbar = (torch.randn((n, 3), generator=g, device="cuda")
            * (margin >= KINK_MARGIN).float()[:, None])
    cp, cp64 = list(color_net.parameters()), list(color64.parameters())
    got = _grads(lambda *a: CK.color_mlp(color_net, *a), ins, cp, [cbar])
    ref = _grads(lambda *a: CK.color_plain(color_net, *a), ins, cp, [cbar])
    ref64 = _grads(lambda *a: CK.color_plain(color64, *a),
                   [t.double() for t in ins], cp64, [cbar.double()])
    _check_vs_f64(got, ref, ref64, "K5")


@pytest.mark.gpu
def test_composed_path_routes_to_k4_and_k5_on_card():
    """Under the negative ray vector ``sdf_grad_color`` on the card runs K4
    and K5 (forward and, under autograd, backward) and no K1; the plain
    yardstick of K1, ``rendercore_fwd_plain``, launches no kernel."""
    _require_cuda()
    scfg, ccfg = WIDTHS["small"]
    ccfg = dataclasses.replace(ccfg, use_negative_ray_vector=True)
    sdf_net = perturb_(TF.SDFNetwork(scfg, torch.Generator().manual_seed(0)),
                       torch.Generator().manual_seed(2)).cuda()
    color_net = perturb_(TF.ColorNetwork(ccfg, torch.Generator().manual_seed(1)),
                         torch.Generator().manual_seed(3)).cuda()
    x, d = _rows(100, seed=5)
    counters = (RC.COUNTER, RC.BWD_COUNTER, OG.FWD_COUNTER, OG.BWD_COUNTER,
                CK.FWD_COUNTER, CK.BWD_COUNTER, SV.COUNTER, SVD.FWD_COUNTER,
                SVD.BWD_COUNTER)

    def launched(fn):
        before = [c.launches for c in counters]
        fn()
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counters, before)]

    def train():
        sdf, grad, color = TF.sdf_grad_color(sdf_net, color_net, x, d)
        (sdf.sum() + grad.square().sum() + color.sum()).backward()

    def render():
        with torch.no_grad():
            TF.sdf_grad_color(sdf_net, color_net, x, d)

    def plain():
        RC.rendercore_fwd_plain(sdf_net, color_net, x, d)
        with torch.no_grad():
            RC.rendercore_fwd_plain(sdf_net, color_net, x, d)

    assert launched(train) == [0, 0, 1, 1, 1, 1, 0, 0, 0]
    assert launched(render) == [0, 0, 1, 0, 1, 0, 0, 0, 0]
    assert launched(plain) == [0] * len(counters)
    assert all(p.grad is not None for p in sdf_net.parameters())
    assert all(p.grad is not None for p in color_net.parameters())


def _fwd_close(got, ref, names):
    """Forward outputs: 1e-4 absolute, grad 1e-4 x max(1, max|grad|)."""
    for name, g, r in zip(names, got, ref):
        tol = 1e-4 * (max(1.0, r.abs().max().item()) if name == "grad" else 1)
        torch.testing.assert_close(g, r, rtol=0, atol=tol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_fold_kernels_match_plain_on_card(width, n):
    """K6-fwd against ``rendercore_cons_plain`` (K1's and K3's plain
    versions), and K6-bwd (through ``RenderCoreCons``) against autograd of
    the plain version and f64 for sbar, gbar, cbar and swbar alone and all
    four: x_bar, dirs_bar, y_bar and every parameter of both nets."""
    _require_cuda()
    sdf_net, color_net = _nets(width, "cuda")
    x, d = _rows(n, seed=n + 13)
    y, _ = _rows(n, seed=n + 17)
    with torch.no_grad():
        _fwd_close(RCC.rendercore_cons(sdf_net, color_net, x, d, y),
                   RCC.rendercore_cons_plain(sdf_net, color_net, x, d, y),
                   ("sdf", "grad", "color", "sdf_w"))
    params = [*sdf_net.parameters(), *color_net.parameters()]
    sdf64, color64 = copy.deepcopy(sdf_net).double(), copy.deepcopy(color_net).double()
    g = torch.Generator(device="cuda").manual_seed(n + 2)
    full = [torch.randn(s, generator=g, device="cuda")
            for s in ((n, 1), (n, 4), (n, 3), (n,))]
    margin = RC.color_relu_margin(sdf64, color64, x.double(), d.double())
    full[2] = full[2] * (margin >= KINK_MARGIN).float()[:, None]
    norms = []
    for on in ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)):
        cots = [c * m for c, m in zip(full, on)]
        got = _grads(lambda *a: RCC.rendercore_cons(sdf_net, color_net, *a),
                     (x, d, y), params, cots)
        ref = _grads(lambda *a: RCC.rendercore_cons_plain(sdf_net, color_net, *a),
                     (x, d, y), params, cots)
        ref64 = _grads(lambda *a: RCC.rendercore_cons_plain(sdf64, color64, *a),
                       (x.double(), d.double(), y.double()),
                       [*sdf64.parameters(), *color64.parameters()],
                       [c.double() for c in cots])
        scales = [sum(t) for t in zip(*norms)] if sum(on) == 4 else None
        norms.append([c.norm().item() for c in ref64])
        _check_vs_f64(got, ref, ref64, f"K6 {on}", scales)


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_sdf_out_kernels_match_plain_on_card(width, n):
    """K7-fwd against ``sdf_apply`` and K7-bwd (through ``SdfOut``) against
    autograd of it and f64, for the head's cotangent on column 0, on the
    feature columns and on all of it."""
    _require_cuda()
    sdf_net, _ = _nets(width, "cuda")
    sdf64 = copy.deepcopy(sdf_net).double()
    x, _ = _rows(n, seed=n + 19)
    with torch.no_grad():
        torch.testing.assert_close(TF.sdf_output(sdf_net, x),
                                   SO.sdf_out_plain(sdf_net, x), rtol=0, atol=1e-4)
    d_out = sdf_net.cfg.d_out
    g = torch.Generator(device="cuda").manual_seed(n + 3)
    obar = torch.randn((n, d_out), generator=g, device="cuda")
    col0 = torch.zeros(d_out, device="cuda")
    col0[0] = 1.0
    sp, sp64 = list(sdf_net.parameters()), list(sdf64.parameters())
    norms = []
    for mask in (col0, 1.0 - col0, torch.ones_like(col0)):
        cots = [obar * mask]
        got = _grads(lambda a: TF.sdf_output(sdf_net, a), (x,), sp, cots)
        ref = _grads(lambda a: SO.sdf_out_plain(sdf_net, a), (x,), sp, cots)
        ref64 = _grads(lambda a: SO.sdf_out_plain(sdf64, a), (x.double(),), sp64,
                       [c.double() for c in cots])
        scales = [sum(t) for t in zip(*norms)] if len(norms) == 2 else None
        norms.append([c.norm().item() for c in ref64])
        _check_vs_f64(got, ref, ref64, "K7", scales)


@pytest.mark.gpu
def test_fold_switch_and_sdf_output_route_to_k6_and_k7_on_card(monkeypatch):
    """``sdf_grad_color_cons`` under grad composes K1 + K3 by default and
    runs K6 alone under ``COPENERF_FOLD_CONS=1``; ``sdf_output`` runs K7."""
    _require_cuda()
    sdf_net, color_net = _nets("small", "cuda")
    x, d = _rows(100, seed=6)
    y, _ = _rows(100, seed=7)
    counters = (RC.COUNTER, RC.BWD_COUNTER, SVD.FWD_COUNTER, SVD.BWD_COUNTER,
                RCC.FWD_COUNTER, RCC.BWD_COUNTER, SO.FWD_COUNTER, SO.BWD_COUNTER)

    def launched(fn):
        before = [c.launches for c in counters]
        fn()
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counters, before)]

    def step():
        sdf, grad, color, sdf_w = TF.sdf_grad_color_cons(sdf_net, color_net, x, d, y)
        (sdf.sum() + grad.square().sum() + color.sum() + sdf_w.sum()).backward()

    def output():
        TF.sdf_output(sdf_net, x).sum().backward()

    monkeypatch.delenv("COPENERF_FOLD_CONS", raising=False)
    assert launched(step) == [1, 1, 1, 1, 0, 0, 0, 0]
    monkeypatch.setenv("COPENERF_FOLD_CONS", "1")
    assert launched(step) == [0, 0, 0, 0, 1, 1, 0, 0]
    assert launched(output) == [0, 0, 0, 0, 0, 0, 1, 1]
