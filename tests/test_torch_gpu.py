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
import os

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
    # Every layer, the feature head and the color layers past one
    # warpgroup's 128 columns, with K tails.
    "wide": (TF.SDFConfig(d_out=161, d_hidden=160, n_layers=4, skip_in=(2,),
                          multires=3),
             TF.ColorConfig(d_feature=160, d_hidden=160, n_layers=3,
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


def _step_card_and_cpu(stage1: bool):
    """One step at a small width, 64 rays, injected ray_idx and t_rand, on
    the card (kernels) and on the CPU (plain versions): every metric within
    1e-4 relative + 1e-5, every parameter gradient within 1e-3 of its
    tensor's largest entry. Stage 2 queries at the world camera's time
    through a world_mat with a rotation, the motion net frozen."""
    _require_cuda()
    h = w = 24
    f = 60.0
    K = torch.tensor([[2 * f / w, 0, 0, 0], [0, -2 * f / h, 0, 0],
                      [0, 0, -1, 0], [0, 0, 0, 1]])
    world = torch.eye(4)
    world[2, 3] = -2.5
    if not stage1:
        c, s_ = np.cos(0.1), np.sin(0.1)
        world[:3, :3] = torch.tensor([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    imgs = torch.stack([torch.stack([0.5 + 0.4 * torch.sin(0.25 * xx + 0.2 * (c + 1) * yy
                                                           + 0.3 * t + c)
                                     for c in range(3)]) for t in range(7)])
    g = torch.Generator().manual_seed(0)
    idx = TS.sample_patch_indices(g, h, w, 4, 64, device="cpu")
    t_rand = torch.rand((64, 16), generator=g)
    scfg, ccfg = WIDTHS["small"]
    s = TS.StepStatic(h=h, w=w, patch_size=4, n_points=64, stage1=stage1,
                      n_images=7, nb_sample_timestep=4, n_ref=3,
                      train_motion=stage1, sdf_cons_pose_grad=True,
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
            "query_time_step": torch.tensor(-0.2 if stage1 else 0.0,
                                            device=dev),
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
                    [p.grad.cpu() if p.grad is not None else torch.zeros_like(p).cpu()
                     for k in ("sdf", "color", "variance", "motion")
                     for p in fields[k].parameters()])
    for k, v in res["cpu"][0].items():
        assert abs(res["cuda"][0][k] - v) <= 1e-4 * abs(v) + 1e-5, (k, v)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item() + 1e-6
    return res


@pytest.mark.gpu
def test_train_step_card_matches_cpu():
    """A stage-1 step on the card against the CPU (``_step_card_and_cpu``)."""
    _step_card_and_cpu(stage1=True)


@pytest.mark.gpu
def test_stage2_train_step_card_matches_cpu():
    """A stage-2 step (no sdf-consistency query: no K3; a rotated
    world_mat) on the card against the CPU; the launches are 2 K2 + 1
    K1-fwd + 1 K1-bwd (``up_sample_steps`` 2)."""
    counters = {"sdf_value": SV.COUNTER, "rendercore_fwd": RC.COUNTER,
                "rendercore_bwd": RC.BWD_COUNTER,
                "sdf_value_diff_fwd": SVD.FWD_COUNTER,
                "sdf_value_bwd": SVD.BWD_COUNTER}
    for c in counters.values():
        c.launches = 0
    res = _step_card_and_cpu(stage1=False)
    assert {k: c.launches for k, c in counters.items()} == {
        "sdf_value": 2, "rendercore_fwd": 1, "rendercore_bwd": 1,
        "sdf_value_diff_fwd": 0, "sdf_value_bwd": 0}
    assert all(np.isfinite(v) for v in res["cuda"][0].values())


@pytest.mark.gpu
def test_pose_refinement_card_matches_cpu():
    """``run_pose_refinement`` on the card against the same call on the CPU
    for 12 epochs (6 views at 48x64, batches of 4 and 1 pairs): the poses
    within 1e-4 absolute (the bound the CPU tests hold the port to against
    the JAX package, for the same reason), the loss trace's first epoch
    within 1e-5 relative and the trace within 5e-4."""
    _require_cuda()
    from copenerf_torch.training.pose_refinement import run_pose_refinement

    rng = np.random.default_rng(0)
    m, h, w = 6, 48, 64
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    freq = rng.uniform(0.05, 0.15, size=(3, 2))
    images = np.stack([np.stack([
        0.5 + 0.4 * np.sin(freq[c, 0] * (xs + 1.5 * v) + freq[c, 1] * ys + c)
        for c in range(3)]) for v in range(m)]).astype(np.float32)
    depths = np.stack([2.0 + np.sin(0.07 * xs + 0.05 * ys + 0.3 * v)
                       for v in range(m)]).astype(np.float32)
    k33 = np.tile(np.array([[2.0, 0, 0], [0, -2.0, 0], [0, 0, -1]],
                           np.float32), (m, 1, 1))

    class Recorder:
        def __init__(self):
            self.loss = []

        def add_scalar(self, tag, value, step):
            if tag.endswith("/_loss"):
                self.loss.append(value)

    out = {}
    for dev in ("cuda", "cpu"):
        log = Recorder()
        poses = run_pose_refinement(images, depths, k33, epochs=12,
                                    batch_size=4, logger=log, device=dev)
        out[dev] = (poses, np.asarray(log.loss))
    (pc, lc), (pp, lp) = out["cuda"], out["cpu"]
    assert pc.shape == (m, 4, 4) and np.isfinite(pc).all()
    np.testing.assert_allclose(pc, pp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lc[0], lp[0], rtol=1e-5)
    np.testing.assert_allclose(lc, lp, rtol=5e-4)
    assert lc[-1] < lc[0]


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


# The 3xTF32 tensor-core cores of every row kernel (csrc/wgmma_tile.cuh) and
# of the weight-gradient reduction (csrc/wgrad.cu), through
# csrc/tc_check.cu: the error against an f64 product must stay within 2x
# that of an f32 FFMA version, on the same inputs.
# The tile GEMM's activation columns past K hold NaN, so a read past K shows.
TILE_WIDTHS = [(52, 256), (256, 204), (204, 256), (292, 256), (256, 52),
               (256, 36), (28, 64), (64, 28), (64, 48), (48, 32)]
REDUCE_WIDTHS = [(257, 256), (257, 52), (256, 292), (160, 292), (256, 52), (204, 256),
                 (3, 256), (3, 268), (1, 256), (33, 64), (64, 28), (48, 56)]


TC_PRODUCT_TOL = 2.0 ** -21      # a 3xTF32 product's own relative error


def _tc_inputs(shape, seed, nonneg=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randn(shape, generator=g, device="cuda")
    return t.abs() if nonneg else t


@pytest.mark.gpu
@pytest.mark.parametrize("O,I", REDUCE_WIDTHS)
def test_tc_row_reduction_odd_widths_on_card(O, I):
    """The reduction every backward kernel runs (wgmma, 3xTF32) on staged
    rows whose padding columns hold NaN (never read), at widths past one
    128 x 128 tile and the heads' O = 257 and O = 3: weights and bias against
    f64, within 2x the FFMA reduction's error or TC_PRODUCT_TOL (at one row
    each output is one product, which f32 rounds once and 3xTF32 leaves
    lo * lo out of)."""
    from copenerf_torch.ops.kernels import tc_check as TC

    _require_cuda()
    for n in (1, 1000, 2500):
        z = torch.full((n, (O + 3) // 4 * 4), float("nan"), device="cuda")
        t = torch.full((n, (I + 3) // 4 * 4), float("nan"), device="cuda")
        z[:, :O] = _tc_inputs((n, O), seed=O + n)
        t[:, :I] = _tc_inputs((n, I), seed=I * n, nonneg=True)
        ref = z[:, :O].double().T @ t[:, :I].double()
        ref_b = z[:, :O].double().sum(0)
        w_f, b_f = TC.row_reduce(z, t, O, I, "ffma")
        w_t, b_t = TC.row_reduce(z, t, O, I, "wg")
        assert TC.rel_err(w_t, ref) <= max(2 * TC.rel_err(w_f, ref), TC_PRODUCT_TOL), (O, I, n)
        assert TC.rel_err(b_t, ref_b) <= 2 * TC.rel_err(b_f, ref_b) + 1e-7, (O, I, n)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["64x52x256", "64x256x256", "64x256x204",
                                   "64x292x256", "reduce 1024x256x256"])
def test_tc_accuracy_trial_on_card(shape):
    """The accuracy trial at the shapes K1 multiplies (the tile GEMM on
    K1-bwd's one-stage wgmma ring over 528 tiles; the reduction over one
    1,024-row split): 3xTF32 within 2x the FFMA GEMM's error against f64,
    for activations >= 0 and of either sign."""
    from copenerf_torch.ops.kernels import tc_check as TC

    _require_cuda()
    for nonneg in (True, False):
        if shape.startswith("reduce"):
            z = _tc_inputs((1024, 256), seed=1)
            t = _tc_inputs((1024, 256), seed=2, nonneg=nonneg)
            ref = z.double().T @ t.double()
            errs = [TC.rel_err(TC.row_reduce(z, t, 256, 256, m)[0], ref)
                    for m in ("ffma", "wg")]
        else:
            _, K, N = (int(v) for v in shape.split("x"))
            a = _tc_inputs((64 * 528, K), seed=K, nonneg=nonneg)
            w = _tc_inputs((K, N), seed=N) / K ** 0.5
            ref = a.double() @ w.double()
            errs = [TC.rel_err(TC.tile_gemm(a, w, m), ref) for m in ("ffma", "wg_1stage")]
        assert errs[1] <= 2 * errs[0], (shape, nonneg, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", TILE_WIDTHS)
def test_wg_tile_gemm_odd_widths_on_card(K, N):
    """The wgmma core of every row kernel (csrc/wgmma_tile.cuh): as shipped,
    with the two-stage ring (K1-fwd, K6-fwd, K2, K3, K4-fwd, K5-fwd, K7) and
    the one-stage ring (K1-bwd, K6-bwd, K4-bwd, K5-bwd),
    within 2x the FFMA GEMM's error against f64; every variant exact on
    small integers (the fragment layouts, the descriptor strides, the
    swizzle, the ring's barrier phases)."""
    from copenerf_torch.ops.kernels import tc_check as TC

    _require_cuda()
    for m in (1, 70, 4096):
        a = _tc_inputs((m, K), seed=K * N + m, nonneg=True)
        w = _tc_inputs((K, N), seed=K + N) / K ** 0.5
        ref = a.double() @ w.double()
        e_ffma = TC.rel_err(TC.tile_gemm(a, w, "ffma"), ref)
        for mode in ("wg", "wg_1stage"):
            e_wg = TC.rel_err(TC.tile_gemm(a, w, mode), ref)
            assert e_wg <= 2 * e_ffma, (K, N, m, mode, e_wg, e_ffma)
    g = torch.Generator(device="cuda").manual_seed(K * N)
    a = torch.randint(-8, 9, (70, K), generator=g, device="cuda").float()
    w = torch.randint(-8, 9, (K, N), generator=g, device="cuda").float()
    ref = a.double() @ w.double()
    for mode in TC.WG_MODES:
        assert torch.equal(TC.tile_gemm(a, w, mode).double(), ref), mode


@pytest.mark.gpu
@pytest.mark.parametrize("O,I", [(257, 52), (160, 292), (3, 268)])
def test_tc_row_reduction_pairs_exact_on_card(O, I):
    """The reduction on small integers (exact in TF32 and in every sum) over
    2,500 rows: a second pair that stops at row 1,300 (the render-core
    backward's sweep rows; its later rows hold values no sum may read), and
    ones for z stopping at row 700 (its row-0 job)."""
    from copenerf_torch.ops.kernels import tc_check as TC

    _require_cuda()
    n = 2500
    g = torch.Generator(device="cuda").manual_seed(O + I)

    def ints(width):
        out = torch.full((n, -(-width // 4) * 4), float("nan"), device="cuda")
        out[:, :width] = torch.randint(-8, 9, (n, width), generator=g,
                                       device="cuda").float()
        return out

    z, t, z2, t2 = ints(O), ints(I), ints(O), ints(I)
    w, b = TC.row_reduce(z, t, O, I, pair2=(z2, t2, 1300))
    ref = (z[:, :O].double().T @ t[:, :I].double()
           + z2[:1300, :O].double().T @ t2[:1300, :I].double())
    assert torch.equal(w.double(), ref), (O, I)
    assert torch.equal(b.double(), z[:, :O].double().sum(0)), (O, I)
    w, b = TC.row_reduce(None, t, O, I, rows=700)
    ref = t[:700, :I].double().sum(0).expand(O, I)
    assert torch.equal(w.double(), ref), (O, I)
    assert torch.equal(b, torch.full((O,), 700.0, device="cuda")), (O, I)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["64x52x256", "64x256x256", "64x256x204",
                                   "64x204x256"])
def test_wg_accuracy_trial_on_card(shape):
    """The wgmma core at the shapes K2 and K3 multiply, over 528 tiles: as
    shipped within 2x the FFMA GEMM's error against f64, for activations
    >= 0 and of either sign."""
    from copenerf_torch.ops.kernels import tc_check as TC

    _require_cuda()
    _, K, N = (int(v) for v in shape.split("x"))
    for nonneg in (True, False):
        a = _tc_inputs((64 * 528, K), seed=K + 1, nonneg=nonneg)
        w = _tc_inputs((K, N), seed=N + 1) / K ** 0.5
        ref = a.double() @ w.double()
        errs = [TC.rel_err(TC.tile_gemm(a, w, m), ref) for m in ("ffma", "wg")]
        assert errs[1] <= 2 * errs[0], (shape, nonneg, errs)


def _grads_in_slices(fn, x, params, obar, sl):
    """``_grads`` of fn over row slices of ``sl`` rows: x_bar concatenated,
    parameter gradients summed (the plain f64 graph of 262,144 full-width
    rows is large)."""
    acc = None
    for i in range(0, x.shape[0], sl):
        gr = _grads(fn, (x[i:i + sl],), params, [obar[i:i + sl]])
        if acc is None:
            acc = [[gr[0]]] + gr[1:]
        else:
            acc[0].append(gr[0])
            acc[1:] = [u + v for u, v in zip(acc[1:], gr[1:])]
    return [torch.cat(acc[0])] + acc[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 262144])
def test_value_kernels_match_plain_at_full_width_on_card(n):
    """K2 (and K3-fwd, its kernel) against the plain value to 1e-4, and
    K3-bwd's every gradient against f64 within 2x the plain f32 version's
    error (or 1e-5 of its norm), at full width on the main path's row
    counts."""
    _require_cuda()
    sdf_net, _ = _nets("full", "cuda")
    x, _ = _rows(n, seed=n + 3)
    with torch.no_grad():
        torch.testing.assert_close(SV.sdf_value_cuda(sdf_net, x),
                                   SV.sdf_value_plain(sdf_net, x), rtol=0, atol=1e-4)
    obar = torch.randn((n,), generator=torch.Generator(device="cuda").manual_seed(n),
                       device="cuda")
    sdf64 = copy.deepcopy(sdf_net).double()
    sp = list(sdf_net.parameters())
    got = _grads(lambda a: SVD.sdf_value_diff(sdf_net, a), (x,), sp, [obar])
    ref = _grads_in_slices(lambda a: SVD.sdf_value_diff_plain(sdf_net, a), x, sp,
                           obar, 65536)
    ref64 = _grads_in_slices(lambda a: SVD.sdf_value_diff_plain(sdf64, a), x.double(),
                             list(sdf64.parameters()), obar.double(), 32768)
    _check_vs_f64(got, ref, ref64, f"K3 at {n} rows")


# K5 past one warpgroup (d_hidden 160), with a K tail in every hidden GEMM
# (136), and with a color input past 256 columns (k0 = 268: layer 0's tail
# slice and h0_bar's second pass), as the host emulation's cases.
COLOR_WIDE = {
    "hidden160": TF.ColorConfig(d_feature=64, d_hidden=160, n_layers=3, multires_view=2),
    "hidden136": TF.ColorConfig(d_feature=64, d_hidden=136, n_layers=3, multires_view=2),
    "k0_268": TF.ColorConfig(d_feature=232, d_hidden=64, n_layers=2, multires_view=4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(COLOR_WIDE))
@pytest.mark.parametrize("n", [1000, 4096])
def test_color_kernels_past_one_warpgroup_on_card(name, n):
    """K5-fwd against its plain version to 1e-4 (the feature a column slice
    of a wider head), and K5-bwd's gradient of every input and weight
    against f64 within 2x the plain f32 version's error (or 1e-5 of its
    norm), no color cotangent on rows within KINK_MARGIN of a ReLU's kink."""
    _require_cuda()
    cfg = COLOR_WIDE[name]
    net = perturb_(TF.ColorNetwork(cfg, torch.Generator().manual_seed(cfg.d_hidden)),
                   torch.Generator().manual_seed(5)).cuda()
    x, d = _rows(n, seed=n + 17)
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)).cuda()
    head = torch.from_numpy(0.5 * rng.normal(size=(n, cfg.d_feature + 1))
                            .astype(np.float32)).cuda()
    with torch.no_grad():
        torch.testing.assert_close(CK.color_fwd_cuda(net, x, d, g, head[:, 1:]),
                                   CK.color_plain(net, x, d, g, head[:, 1:]),
                                   rtol=0, atol=1e-4)
    ins = (x, d, g, head[:, 1:].contiguous())
    net64 = copy.deepcopy(net).double()
    margin = CK.color_relu_margin(net64, *[t.double() for t in ins])
    cbar = (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).cuda()
            * (margin >= KINK_MARGIN).float()[:, None])
    cp, cp64 = list(net.parameters()), list(net64.parameters())
    got = _grads(lambda *a: CK.color_mlp(net, *a), ins, cp, [cbar])
    ref = _grads(lambda *a: CK.color_plain(net, *a), ins, cp, [cbar])
    ref64 = _grads(lambda *a: CK.color_plain(net64, *a), [t.double() for t in ins],
                   cp64, [cbar.double()])
    _check_vs_f64(got, ref, ref64, f"K5 {name}")


@pytest.mark.gpu
def test_tensor_core_instructions_per_kernel_on_card():
    """``cuobjdump -sass`` of the built library: every row kernel (K1-fwd
    and K6-fwd, K1-bwd and K6-bwd, K2, K3-bwd, K4-fwd and K7-fwd, K4-bwd,
    K5-fwd, K5-bwd, K7-bwd) and the weight-gradient reduction of every
    backward kernel issue TF32 HGMMA (wgmma) and no HMMA; the FFMA
    reduction (the accuracy trial's control) and the final sums issue
    neither."""
    import re
    import shutil
    import subprocess

    from copenerf_torch.ops.kernels import build

    _require_cuda()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.build()], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        m = re.search(r"([a-z_]+_kernel)", name)
        if m is None:
            continue
        key = m.group(1) + ("<1>" if "ILb1E" in name else "")
        funcs[key] = funcs.get(key, "") + body
    wg = ["sdf_value_kernel", "sdf_value_bwd_kernel", "sdf_outgrad_fwd_kernel",
          "sdf_outgrad_fwd_kernel<1>", "sdf_outgrad_bwd_kernel", "color_fwd_kernel",
          "color_bwd_kernel", "sdf_out_bwd_kernel", "wgrad_wg_partial_kernel",
          "rendercore_fwd_kernel", "rendercore_fwd_kernel<1>", "rendercore_bwd_kernel",
          "rendercore_bwd_kernel<1>"]
    ffma = ["wgrad_partial_kernel", "wgrad_final_kernel"]
    for k in wg:
        assert re.search(r"HGMMA\.[\w.]*TF32", funcs[k]), k
        assert "HMMA" not in funcs[k].replace("HGMMA", ""), k
    for k in ffma:
        assert "HMMA" not in funcs[k] and "HGMMA" not in funcs[k], k


def _tiny_trainer_cfg(tmp_path):
    """A 2-frame 24x32 synthetic scene and small nets."""
    from copenerf_torch.config.loader import load_config
    from copenerf_torch.data.synthetic import make_scene

    path, name = make_scene(str(tmp_path / "scene"), n_frames=2, h=24, w=32)
    cfg = load_config(None)
    cfg["dataloading"].update({"path": path, "scene": [name]})
    cfg["rendering"]["depth_range"] = [0.5, 3.5]
    cfg["training"].update({
        "out_dir": str(tmp_path / "out"), "original_resolution": [24, 32],
        "resolution": [24, 32], "n_training_points": 64,
        "start_query_world_epoch": 100, "pretrained_sdf_path": None,
        "depth_bound_update_every_milestones": [0, 0, 0]})
    cfg["neus_sdf_network"].update({"d_hidden": 64, "n_layers": 4,
                                    "skip_in": [2], "d_out": 33})
    cfg["neus_rendering_network"].update({"d_feature": 32, "d_hidden": 32,
                                          "n_layers": 2})
    cfg["motion_network"].update({"d_hidden": 32, "n_layers": 2,
                                  "skip_in": [1]})
    cfg["neus_nerf"].update({"D": 2, "W": 32})
    cfg["neus_renderer"].update({"n_samples": 16, "n_importance": 16,
                                 "up_sample_steps": 2})
    return cfg


@pytest.mark.gpu
def test_trainer_steps_and_checkpoint_round_trip_on_card(tmp_path):
    """A tiny-config ``Trainer`` on the card: 2 stage-1 iterations on a
    2-frame synthetic scene, each through 2 K2 (``up_sample_steps`` 2) + 1
    K1-fwd + 1 K1-bwd + 1 K3-fwd + 1 K3-bwd launches; its checkpoint resumes
    in a second ``Trainer`` with the same iteration, weights and Adam
    states."""
    _require_cuda()
    from copenerf_torch.training.trainer import Trainer

    cfg = _tiny_trainer_cfg(tmp_path)
    counters = {"sdf_value": SV.COUNTER, "rendercore_fwd": RC.COUNTER,
                "rendercore_bwd": RC.BWD_COUNTER,
                "sdf_value_diff_fwd": SVD.FWD_COUNTER,
                "sdf_value_bwd": SVD.BWD_COUNTER}
    for c in counters.values():
        c.launches = 0
    first = Trainer(cfg, verbose=False)
    first.train(max_epochs=1)
    got = {k: c.launches for k, c in counters.items()}
    assert first.it == 1
    assert got == {"sdf_value": 4, "rendercore_fwd": 2, "rendercore_bwd": 2,
                   "sdf_value_diff_fwd": 2, "sdf_value_bwd": 2}
    first.save_checkpoint()
    second = Trainer(cfg, verbose=False)
    assert second.it == first.it and second.checkpoint_loaded
    from copenerf_torch.training.checkpoints import _flatten

    a = _flatten(TS.train_state_to_jax(first.state))
    b = _flatten(TS.train_state_to_jax(second.state))
    assert int(a["opt_fields/#0"]) == 2 and set(a) == set(b)
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


@pytest.mark.gpu
def test_image_metrics_exact_f32_on_card():
    """SSIM and LPIPS on the card with cuDNN's TF32 switched on by the test
    (PyTorch's default), against float64 on the CPU: SSIM within 1e-6,
    LPIPS within 1e-5 relative; the metrics force f32 themselves and leave
    the caller's setting as it was."""
    _require_cuda()
    from copenerf_torch.evaluation import lpips_torch
    from copenerf_torch.evaluation.metrics_image import ssim

    rng = np.random.default_rng(0)
    h, w = 64, 96
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    a = np.stack([0.5 + 0.3 * np.sin(0.15 * xs + 0.1 * (c + 1) * ys + c)
                  for c in range(3)]) + 0.1 * rng.uniform(-1, 1, (3, h, w))
    a = np.clip(a, 0, 1)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    params64 = {"stages": [], "heads": []}
    c_in = 3
    for idxs, c_out in zip(lpips_torch._VGG16_STAGES,
                           lpips_torch.STAGE_CHANNELS):
        params64["stages"].append([
            {"w": torch.from_numpy(rng.normal(
                scale=np.sqrt(2.0 / (9 * (c_in if k == 0 else c_out))),
                size=(c_out, c_in if k == 0 else c_out, 3, 3))),
             "b": torch.from_numpy(rng.normal(scale=0.05, size=c_out))}
            for k in range(len(idxs))])
        params64["heads"].append(torch.from_numpy(
            np.abs(rng.normal(size=(1, c_out, 1, 1)))))
        c_in = c_out
    params32 = {"stages": [[{k: v.float().cuda() for k, v in layer.items()}
                            for layer in stage]
                           for stage in params64["stages"]],
                "heads": [hd.float().cuda() for hd in params64["heads"]]}
    a64, b64 = torch.from_numpy(a), torch.from_numpy(b)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        s_card = float(ssim(a64.float().cuda(), b64.float().cuda()))
        l_card = float(lpips_torch.lpips(params32, a64.float().cuda(),
                                         b64.float().cuda()))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    s_ref = float(ssim(a64, b64))
    l_ref = float(lpips_torch.lpips(params64, a64, b64))
    assert abs(s_card - s_ref) <= 1e-6, (s_card, s_ref)
    assert abs(l_card - l_ref) <= 1e-5 * abs(l_ref), (l_card, l_ref)


@pytest.mark.gpu
def test_eval_pose_step_card_matches_cpu():
    """One test-time pose step (``evaluator.pose_loss``, the fields frozen)
    for view 1 of a whole (2, 3) ``r``, ``t`` on the card against the CPU:
    the loss within 1e-4 relative, each gradient within 1e-3 of its
    largest entry (the stage-2 step's bounds), the other view's rows zero;
    2 K2 + 1 K1-fwd + 1 K1-bwd launches (``up_sample_steps`` 2) and no
    gradient on any field weight."""
    _require_cuda()
    from copenerf_torch.evaluation.evaluator import frozen, pose_loss

    h = w = 24
    f = 60.0
    K = torch.tensor([[2 * f / w, 0, 0, 0], [0, -2 * f / h, 0, 0],
                      [0, 0, -1, 0], [0, 0, 0, 1]])
    init = torch.eye(4).expand(2, 4, 4).clone()
    init[:, 2, 3] = -2.5
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    image = torch.stack([0.5 + 0.4 * torch.sin(0.25 * xx + 0.2 * (c + 1) * yy + c)
                         for c in range(3)])
    g = torch.Generator().manual_seed(0)
    idx = TS.sample_patch_indices(g, h, w, 1, 64, device="cpu")
    t_rand = torch.rand((64, 16), generator=g)
    rcfg = RendererConfig(n_samples=16, n_importance=16, up_sample_steps=2)
    counters = {"sdf_value": SV.COUNTER, "rendercore_fwd": RC.COUNTER,
                "rendercore_bwd": RC.BWD_COUNTER}
    res = {}
    for dev in ("cuda", "cpu"):
        sdf_net, color_net = _nets("small", dev)
        fields = torch.nn.ModuleDict({
            "sdf": sdf_net, "color": color_net,
            "variance": TF.VarianceNetwork(TF.VarianceConfig()).to(dev)})
        r = torch.tensor([[0.0, 0.0, 0.0], [0.02, -0.03, 0.01]],
                         device=dev, requires_grad=True)
        t = torch.tensor([[0.0, 0.0, 0.0], [0.01, 0.02, -0.015]],
                         device=dev, requires_grad=True)
        for c in counters.values():
            c.launches = 0
        with frozen(fields):
            loss, l2 = pose_loss(fields, rcfg, r[1], t[1], init[1].to(dev),
                                 image.to(dev), K.to(dev), idx.to(dev),
                                 torch.tensor(0.0, device=dev),
                                 torch.full((64, 1), 1.0, device=dev),
                                 torch.full((64, 1), 4.0, device=dev),
                                 t_rand=t_rand.to(dev))
            loss.backward()
        assert all(p.grad is None and p.requires_grad
                   for p in fields.parameters())
        res[dev] = (loss.item(), l2.item(), r.grad.cpu(), t.grad.cpu(),
                    {k: c.launches for k, c in counters.items()})
    (lc, l2c, rc, tc, nc), (lp, l2p, rp, tp, _) = res["cuda"], res["cpu"]
    assert nc == {"sdf_value": 2, "rendercore_fwd": 1, "rendercore_bwd": 1}
    assert abs(lc - lp) <= 1e-4 * abs(lp) + 1e-6
    assert abs(l2c - l2p) <= 1e-4 * abs(l2p) + 1e-6
    for got, ref in ((rc, rp), (tc, tp)):
        assert torch.all(ref[0] == 0) and torch.all(got[0] == 0)
        assert ref[1].abs().max() > 0
        assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


@pytest.mark.gpu
def test_extract_geometry_card_matches_cpu(tmp_path):
    """``Trainer.extract_geometry`` at resolution 48 (110,592 grid points,
    one K2 launch) on the card and on the CPU at time 0, the SDF's
    geometric init perturbed: the same triangles, every vertex within 1e-3
    voxel widths of its counterpart."""
    _require_cuda()
    from copenerf_torch.training.trainer import MESH_BATCH, Trainer

    res = 48
    cfg = _tiny_trainer_cfg(tmp_path)
    meshes = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(copy.deepcopy(cfg), device=dev, verbose=False)
        perturb_(trainer.state["fields"]["sdf"],
                 torch.Generator().manual_seed(3))
        SV.COUNTER.launches = 0
        # At time 0: the geometric init is a 4-D sphere of radius 0.5 in
        # (x, y, z, t), and this 2-frame scene's world time is -1.
        meshes[dev] = trainer.extract_geometry(resolution=res, time_step=0.0)
        launches = SV.COUNTER.launches
        assert launches == (-(-res ** 3 // MESH_BATCH) if dev == "cuda" else 0)
    (vc, tc), (vp, tp) = meshes["cuda"], meshes["cpu"]
    assert len(tp) > 100
    np.testing.assert_array_equal(tc, tp)
    voxel = 2.4 / (res - 1)
    assert np.abs(vc - vp).max() <= 1e-3 * voxel


@pytest.mark.gpu
def test_bench_prints_the_contract_line(monkeypatch, capsys):
    """``copenerf_torch.bench`` at the protocol's 1,024 rays, 2 timed
    steps: one JSON line with the contract's keys, a finite positive
    rate and the card's name."""
    _require_cuda()
    import json

    from copenerf_torch import bench

    monkeypatch.setattr(bench, "ITERS", 2)
    monkeypatch.setattr(bench, "WARMUP", 1)
    bench.main(["--rays", "1024"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "train_rays_per_sec"
    assert line["unit"] == "rays/s" and line["rays_per_step"] == 1024
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 3000.0, 3)
    assert "ESTIMATE" in line["baseline"]
    assert torch.cuda.get_device_name(0) in line["device"]
    # 3 steps (1 warm-up, 2 timed) of 4 K2, K1-fwd, K1-bwd, K3-fwd, K3-bwd.
    per_step = {"sdf_value": 4, "rendercore_fwd": 1, "rendercore_bwd": 1,
                "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1}
    assert {k: v for k, v in line["launches"].items() if v} == {
        k: 3 * n for k, n in per_step.items()}


# ---------------------------------------------------------------------------
# Data parallelism on the card: the ranks are processes running this file
# ---------------------------------------------------------------------------

DP_TIMEOUT = 300
DP_STEPS = 3
DP_RAYS = 128            # 8 patches of 4x4: 4 a rank at world size 2
DP_PER_STEP = {"sdf_value": 2, "rendercore_fwd": 1, "rendercore_bwd": 1,
               "sdf_value_diff_fwd": 1, "sdf_value_bwd": 1}


def _dp_np_batch():
    """The stage-1 batch of ``test_torch_step.py`` (random images), with
    DP_STEPS draws of DP_RAYS global rays and their jitter."""
    rng = np.random.default_rng(0)
    f = 30.0 / 12.0
    k = np.array([[f, 0, 0, 0], [0, -f, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
                 np.float32)
    ray_idx = np.stack([TS.sample_patch_indices(
        torch.Generator().manual_seed(s), 24, 24, 4, DP_RAYS,
        device="cpu").numpy() for s in range(DP_STEPS)])
    return {
        "images_all": rng.uniform(size=(7, 3, 24, 24)).astype(np.float32),
        "K_all": np.stack([k] * 7),
        "ref_idxs": np.asarray([3, 4, 5], np.int32),
        "ref_in_list": np.ones(3, np.float32),
        "ref_valid_flow": np.asarray([1.0, 1.0, 0.0], np.float32),
        "scale_mat": np.eye(4, dtype=np.float32),
        "world_mat": np.eye(4, dtype=np.float32),
        "query_time_step": np.float32(-0.2),
        "world_time_step": np.float32(0.0), "image_idx": np.int32(2),
        "world_cam_idx": np.int32(3), "near": np.float32(0.5),
        "far": np.float32(3.5), "cos_anneal_ratio": np.float32(0.5),
        "weights": np.asarray((1.0, 0.1, 0.1, 7.5, 0.1, 1.0, 1e-4),
                              np.float32),
        "lr": np.float32(1e-3), "motion_lr": np.float32(5e-4),
        "ray_idx": ray_idx,
        "t_rand": rng.uniform(size=(DP_STEPS, DP_RAYS, 16)).astype(np.float32),
    }


def _dp_rank_main(mode, work, rank):
    """A rank of ``nccl1`` (one rank, NCCL) or ``gloo2`` (two ranks on card
    0, Gloo): DP_STEPS data-parallel stage-1 steps of small nets on the
    card; rank 0 also runs the single-device step (``nccl1``) or the
    one-rank gradients of the global batch, in its order and two others,
    at each step's weights (``gloo2``). Writes ``rank<r>.json``."""
    import hashlib
    import json

    import test_torch_parallel as TPL

    from copenerf_torch.parallel import distributed as dist

    world = 1 if mode == "nccl1" else 2
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1" if mode == "nccl1" else "2")
    dist.initialize("nccl" if mode == "nccl1" else "gloo",
                    init_method="file://" + os.path.join(work, "store"),
                    timeout=DP_TIMEOUT)
    group = dist.process_group()
    nb = _dp_np_batch()
    rcfg = RendererConfig(**TPL.STEP_RCFG)
    s = TPL.static("stage1", n_points=DP_RAYS)
    fields = TF.init_all_fields(TPL.STEP_CFGS, torch.Generator().manual_seed(0),
                                device="cpu")
    perturb_(fields["sdf"], torch.Generator().manual_seed(1))
    fields = fields.to("cuda")
    counters = [SV.COUNTER, RC.COUNTER, RC.BWD_COUNTER, SVD.FWD_COUNTER,
                SVD.BWD_COUNTER]

    def batch_of(k, rows=slice(None)):
        b = {key: (v.cuda() if torch.is_tensor(v) else v)
             for key, v in TPL.torch_batch(nb, k).items()}
        return dict(b, ray_idx=b["ray_idx"][rows], t_rand=b["t_rand"][rows])

    def one_rank(flds, b):
        ref = copy.deepcopy(flds)
        total, m = TS.compute_losses(ref, rcfg, s, b, b["ray_idx"],
                                     t_rand=b["t_rand"])
        total.backward()
        return ({k: float(v) for k, v in m.items()},
                [p.grad for k in TPL.stepped_nets("stage1")
                 for p in ref[k].parameters()])

    out = {"launches": [], "metric_rel": [], "grad_worst": [], "detail": []}
    names = [f"{k}.{n}" for k in TPL.stepped_nets("stage1")
             for n, _ in fields[k].named_parameters()]
    state = TS.init_train_state(copy.deepcopy(fields))
    step = TS.build_train_step(rcfg, s, group=group)
    single = TS.init_train_state(copy.deepcopy(fields))
    single_step = TS.build_train_step(rcfg, s)
    reorders = [TPL.reorder_rows(DP_RAYS, seed)
                for seed in range(TPL.N_REORDERS)]
    for k in range(DP_STEPS):
        if mode == "gloo2" and rank == 0:
            ref_m, ref_g = one_rank(state["fields"], batch_of(k))
            others = [one_rank(state["fields"], batch_of(k, rows))[1]
                      for rows in reorders]
        for c in counters:
            c.launches = 0
        m = {key: float(v) for key, v in step(state, batch_of(k)).items()}
        out["launches"].append({c.name: c.launches for c in counters})
        if mode == "nccl1":
            single_step(single, batch_of(k))
        elif rank == 0:
            got = [p.grad for key in TPL.stepped_nets("stage1")
                   for p in state["fields"][key].parameters()]
            out["metric_rel"].append(max(abs(m[key] - v) / (abs(v) + 5e-3)
                                         for key, v in ref_m.items()))
            ratios = []
            for i, (g, r) in enumerate(zip(got, ref_g)):
                diff = float((g - r).abs().max())
                scale = 1e-5 * float(r.abs().max())
                noise = 2 * max(float((o[i] - r).abs().max()) for o in others)
                ratios.append((diff / (max(scale, noise) + 1e-7), names[i],
                               diff, scale, noise))
            ratios.sort(reverse=True)
            out["grad_worst"].append(ratios[0][0])
            out["detail"].append(ratios[:4])
    if mode == "nccl1":
        ref = dict(single["fields"].named_parameters())
        out["param_share"] = max(
            float((p - ref[n]).abs().max() / ref[n].abs().max())
            for n, p in state["fields"].named_parameters())
    digest = hashlib.sha256()
    for p in state["fields"].parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out["params_sha256"] = digest.hexdigest()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


def _run_dp_ranks(mode, world, work):
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(work), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.gpu
def test_nccl_world1_step_matches_single_device_on_card(tmp_path):
    """One rank over NCCL (process group, gradient bucket all-reduce): after
    3 data-parallel stage-1 steps the parameters are within 1e-6 of each
    tensor's largest entry of the single-device step's (the smoke's
    ``dp_nccl1`` bound); every step launches 2 K2 + K1 + K3."""
    _require_cuda()
    (res,) = _run_dp_ranks("nccl1", 1, tmp_path)
    assert res["param_share"] <= 1e-6
    assert all(lc == DP_PER_STEP for lc in res["launches"])


@pytest.mark.gpu
def test_gloo_two_ranks_on_one_card_match_one_rank(tmp_path):
    """Two ranks sharing card 0 over Gloo, 64 rays each: per step the
    global metrics within 2e-5 relative (+ 1e-7) of the one-rank step's on
    the global batch, each gradient tensor within 1e-5 of its largest entry
    or twice the one-rank gradient's own move when the rays are put in
    another order that leaves the loss unchanged
    (``test_torch_parallel.reorder_rows``: f32 summation order), exact
    launches on both ranks, and both ranks' parameters bitwise equal after
    3 steps."""
    _require_cuda()
    r0, r1 = _run_dp_ranks("gloo2", 2, tmp_path)
    assert max(r0["metric_rel"]) <= 2e-5
    assert max(r0["grad_worst"]) <= 1.0, r0["detail"]
    assert all(lc == DP_PER_STEP for r in (r0, r1) for lc in r["launches"])
    assert r0["params_sha256"] == r1["params_sha256"]



# Card-to-CPU tolerance of the micro run (``e2e_port.MICRO``), per metric:
# 3 times the largest gap between the card's and the CPU's run over seeds
# 0-2 as this test prints them (PERF.md §6, the head-to-head's findings),
# each a small share of the metric's values; the depth metrics' gaps are
# below 3e-7 of their values, so they are held to 1e-6 of the CPU's value.
MICRO_CARD_TOL = {"PSNR": 0.0056, "SSIM": 2.7e-4, "LPIPS": 9.4e-4,
                  "rpe_trans": 9.1, "rpe_rot": 0.90, "ate": 0.0046}
MICRO_DEPTH_REL = 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_e2e_micro_run_card_matches_cpu(tmp_path, seed):
    """``e2e_port.py``'s pipeline on its micro schedule (``e2e_port.MICRO``:
    both stages, the refinement, test-time pose optimization and every
    metric) on the card and on the CPU from one init: the same init hash,
    each metric of the card within ``MICRO_CARD_TOL`` of the CPU run's (a
    depth metric within ``MICRO_DEPTH_REL`` of it). Prints the gaps."""
    _require_cuda()
    import json

    import e2e_port as E

    cpu = E.run_torch(str(tmp_path / "cpu"), seed, "cpu", verbose=False,
                      **E.MICRO)
    card = E.run_torch(str(tmp_path / "card"), seed, "cuda", verbose=False,
                       **E.MICRO)
    assert card["init_sha256"] == cpu["init_sha256"]
    gaps = {k: abs(card[k] - cpu[k]) for k in E.METRIC_ORDER}
    print(json.dumps({"seed": seed, "cpu": {k: cpu[k] for k in E.METRIC_ORDER},
                      "card": {k: card[k] for k in E.METRIC_ORDER},
                      "gaps": gaps}))
    for k in E.METRIC_ORDER:
        bound = (MICRO_DEPTH_REL * abs(cpu[k]) if k in E.DEPTH
                 else MICRO_CARD_TOL[k])
        assert gaps[k] <= bound, (k, card[k], cpu[k], bound)


if __name__ == "__main__":
    import sys

    _dp_rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
