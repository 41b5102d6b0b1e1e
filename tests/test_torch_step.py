"""Port parity for the training slice's host side: losses, bilinear warping,
the motion chain's gradients, ``compute_losses`` and the Adam step, against
the JAX package at small widths with exchanged weights and numpy inputs
(injected ray indices and stratified jitter). On the CPU the field queries
take the kernels' plain versions under autograd.

Tolerances: f32 on both sides. The importance chain's fixed inv_s
amplifies last-bit SDF differences into the resampled z
(``test_torch_renderer.py``), so the loss metrics get 2e-5 relative plus
1e-6. Parameter gradients get a share of each tensor's largest entry plus
1e-6: 2e-4 in stage 2, 1e-3 in stage 1, where the flow-rgb term (an L1 of
bilinear warps) has kinks: on these smooth images the JAX gradient itself
moves by up to 2.2e-4 of that share (``sdf.lin0.b``) when t_rand moves by
1e-5 (1.6e-3 on noise images). The first Adam step moves each parameter
by lr g / (|g| + eps), about lr sign(g): where the gradient is above 2e-3
of its tensor's largest entry (its sign is then certain) the updated
parameters get 1e-4 absolute at lr 1e-3, elsewhere they may differ by the
step's whole range 2 lr; a wrong Adam moves every parameter by O(lr)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_tpu.ops import interp as JI
from copenerf_tpu.ops.renderer import RendererConfig as JRendererConfig
from copenerf_tpu.poses import lie as JL
from copenerf_tpu.poses import motion as JM
from copenerf_tpu.training import losses as JLo
from copenerf_tpu.training import step as JS
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.ops import interp as TI
from copenerf_torch.ops.renderer import RendererConfig
from copenerf_torch.poses import lie as TL
from copenerf_torch.poses import motion as TM
from copenerf_torch.training import losses as TLo
from copenerf_torch.training import step as TS

H = W = 24
N_IMAGES = 7
JCFGS = {
    "sdf": JF.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), d_out=33),
    "color": JF.ColorConfig(d_feature=32, d_hidden=32, n_layers=2),
    "motion": JF.MotionConfig(d_hidden=32, n_layers=2, skip_in=(1,)),
    "variance": JF.VarianceConfig(init_val=0.3),
    "nerf": JF.NerfConfig(D=2, W=32),
}
TCLS = {"sdf": TF.SDFConfig, "color": TF.ColorConfig,
        "motion": TF.MotionConfig, "variance": TF.VarianceConfig,
        "nerf": TF.NerfConfig}
TCFGS = {k: TCLS[k](**dataclasses.asdict(v)) for k, v in JCFGS.items()}
RCFG = dict(n_samples=16, n_importance=16, up_sample_steps=2)
METRIC_RTOL, METRIC_ATOL = 2e-5, 1e-6
GRAD_ATOL = 1e-6


def _camera_mat():
    f = 30.0
    return np.array([[2 * f / W, 0, 0, 0], [0, -2 * f / H, 0, 0],
                     [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)


def smooth_images():
    """A smooth synthetic video: shifted sinusoids per channel and frame, so
    that the photometric warp's gradient points somewhere (on noise images
    the flow-rgb term dominates the loss and wanders)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return np.stack([
        np.stack([0.5 + 0.4 * np.sin(0.25 * xx + 0.2 * (c + 1) * yy
                                     + 0.3 * f + c) for c in range(3)])
        for f in range(N_IMAGES)]).astype(np.float32)


def _np_batch():
    return {
        "images_all": smooth_images(),
        "K_all": np.stack([_camera_mat()] * N_IMAGES),
        "ref_idxs": np.asarray([3, 4, 5], np.int32),
        "ref_in_list": np.asarray([1.0, 1.0, 1.0], np.float32),
        "ref_valid_flow": np.asarray([1.0, 1.0, 0.0], np.float32),
        "scale_mat": np.eye(4, dtype=np.float32),
        "world_mat": np.eye(4, dtype=np.float32),
        "query_time_step": np.float32(-0.2),
        "world_time_step": np.float32(0.0),
        "image_idx": np.int32(2),
        "world_cam_idx": np.int32(3),
        "near": np.float32(0.5),
        "far": np.float32(3.5),
        "cos_anneal_ratio": np.float32(0.5),
        "weights": (1.0, 0.1, 0.1, 7.5, 0.1, 1.0, 1e-4),
        "lr": 1e-3,
        "motion_lr": 5e-4,
    }


def jax_batch(nb):
    b = {k: jnp.asarray(v) for k, v in nb.items()
         if k not in ("weights", "lr", "motion_lr")}
    b["loss_weights"] = JS.make_loss_weights(*nb["weights"])
    b["lr"], b["motion_lr"] = jnp.asarray(nb["lr"]), jnp.asarray(nb["motion_lr"])
    return b


def torch_batch(nb):
    b = {k: torch.as_tensor(np.asarray(v)) for k, v in nb.items()
         if k not in ("weights", "lr", "motion_lr")}
    for k in ("ref_idxs", "image_idx", "world_cam_idx"):
        b[k] = b[k].long()
    b["loss_weights"] = TS.make_loss_weights(*nb["weights"])
    b["lr"], b["motion_lr"] = nb["lr"], nb["motion_lr"]
    return b


def static(stage1=True, train_motion=True, pose_grad=False, inject=False):
    return dict(h=H, w=W, patch_size=4, n_points=64, stage1=stage1,
                n_images=N_IMAGES, nb_sample_timestep=4, n_ref=3,
                train_motion=train_motion, sdf_cons_pose_grad=pose_grad,
                use_flow_rgb=stage1, use_sdf_consistency=stage1,
                inject_sampling=inject)


def models(seed=0, color=None):
    """(JAX params, port fields) of JCFGS; ``color``: overrides of the color
    config (the composed field path)."""
    jcfgs, tcfgs = JCFGS, TCFGS
    if color:
        jcfgs = {**JCFGS, "color": dataclasses.replace(JCFGS["color"], **color)}
        tcfgs = {**TCFGS, "color": dataclasses.replace(TCFGS["color"], **color)}
    jp = JF.init_all_fields(jax.random.PRNGKey(seed), jcfgs)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, X.params_from_jax(jp, tcfgs, device="cpu")


def sampling(seed):
    idx = np.asarray(JS.sample_patch_indices(jax.random.PRNGKey(seed), H, W,
                                             4, 64))
    t_rand = np.random.default_rng(seed).uniform(
        size=(64, RCFG["n_samples"])).astype(np.float32)
    return idx, t_rand


def grads_as_jax(net) -> dict:
    if isinstance(net, TF.VarianceNetwork):
        return {"variance": net.variance.grad.numpy()}
    out = {}
    for name, layer in net.layers.items():
        if hasattr(layer, "v"):
            out[name] = {"v": layer.v.grad.numpy().T, "g": layer.g.grad.numpy(),
                         "b": layer.b.grad.numpy()}
        else:
            out[name] = {"w": layer.w.grad.numpy().T, "b": layer.b.grad.numpy()}
    return out


def assert_trees_close(got, ref, rtol, atol, what):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_g) == len(flat_r), what
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        np.testing.assert_allclose(
            np.asarray(g), r, rtol=0, atol=rtol * np.abs(r).max() + atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# Losses and warping
# ---------------------------------------------------------------------------

def _patches(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(5, 4, 4, 1)).astype(np.float32),
            rng.uniform(size=(5, 4, 4, 3)).astype(np.float32))


LOSSES = {
    "smoothness": lambda m, d, a, b: m.smoothness_loss(d),
    "edge_aware": lambda m, d, a, b: m.edge_aware_smoothness_loss(d, a),
    "rgb_l1": lambda m, d, a, b: m.rgb_l1_loss(a.reshape(-1, 3),
                                               b.reshape(-1, 3)),
    "eikonal": lambda m, d, a, b: m.eikonal_loss(a.reshape(-1, 3) - 0.3),
    "sdf_flow": lambda m, d, a, b: m.sdf_flow_loss(
        a.reshape(-1, 3), b.reshape(-1, 3) - 0.5, d.reshape(-1),
        a[..., 0].reshape(-1)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    d, rgb = _patches(1)
    rgb2 = np.ascontiguousarray(rgb[::-1])
    ref = LOSSES[name](JLo, *map(jnp.asarray, (d, rgb, rgb2)))
    got = LOSSES[name](TLo, *map(torch.from_numpy, (d, rgb, rgb2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_ssim_loss_matches_jax():
    """1e-5: the SSIM ratio divides sums of nearly equal local moments."""
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(3, 9, 11)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape).astype(np.float32) * 0.1, 0, 1)
    np.testing.assert_allclose(
        TLo.ssim_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(JLo.ssim_loss(jnp.asarray(x), jnp.asarray(y))), rtol=0,
        atol=1e-5)


def test_warp_pixels_and_coordinate_gradient():
    """Values and the gradient w.r.t. the pixel coordinates, at interior
    pixels and at and beyond every border (the floor clamps to w-2 / h-2,
    so the last column and row still carry a slope)."""
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(3, 7, 9)).astype(np.float32)
    uv = np.array([[2.3, 3.7], [4.5, 1.2], [0.0, 0.0], [8.0, 6.0],
                   [8.0, 2.5], [3.5, 6.0], [-1.5, 2.0], [9.7, 7.4]],
                  np.float32)
    wts = rng.normal(size=(uv.shape[0], 3)).astype(np.float32)

    def jf(u):
        return jnp.sum(JI.warp_pixels(jnp.asarray(img), u) * wts)

    ref_v = JI.warp_pixels(jnp.asarray(img), jnp.asarray(uv))
    ref_g = jax.grad(jf)(jnp.asarray(uv))
    ut = torch.from_numpy(uv).requires_grad_(True)
    got = TI.warp_pixels(torch.from_numpy(img), ut)
    (got * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_v),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(ref_g), rtol=0,
                               atol=1e-5)


def test_motion_chain_gradients_match_jax():
    """Gradients of ``full_video_w2c`` and ``se3_inverse`` w.r.t. the
    motion net, through a random linear functional of both."""
    jp, tp = models(1)
    net = tp["motion"]
    rng = np.random.default_rng(4)
    c1 = rng.normal(size=(N_IMAGES, 4, 4)).astype(np.float32)
    c2 = rng.normal(size=(4, 4)).astype(np.float32)

    def jf(p):
        w2c = JM.full_video_w2c(JCFGS["motion"], p, N_IMAGES, 4)
        rel = w2c[5] @ JL.se3_inverse(w2c[2])
        return jnp.sum(w2c * c1) + jnp.sum(rel * c2)

    ref = jax.grad(jf)(jp["motion"])
    w2c = TM.full_video_w2c(net, N_IMAGES, 4)
    rel = w2c[5] @ TL.se3_inverse(w2c[2])
    (torch.sum(w2c * torch.from_numpy(c1))
     + torch.sum(rel * torch.from_numpy(c2))).backward()
    assert_trees_close(grads_as_jax(net), ref, 1e-5, 1e-6, "motion")


# ---------------------------------------------------------------------------
# compute_losses and the step
# ---------------------------------------------------------------------------

# The composed field path (K4 + K5 on the card): the negative ray vector,
# and a mode without normals (its color input has no view-dir PE: the JAX
# ColorConfig.dims quirk of ROADMAP Queue 3).
NEGATIVE_RAY = {"use_negative_ray_vector": True}
NO_NORMAL = {"mode": "no_normal", "d_in": 7, "multires_view": 0}

CASES = {  # (static switches, gradient tolerance share, color overrides)
    "stage1": (static(), 1e-3, None),
    "stage1_pose_grad": (static(pose_grad=True), 1e-3, None),
    "stage2": (static(stage1=False, train_motion=False), 2e-4, None),
    "stage1_negative_ray": (static(), 1e-3, NEGATIVE_RAY),
    "stage1_no_normal": (static(), 1e-3, NO_NORMAL),
    "stage2_negative_ray": (static(stage1=False, train_motion=False), 2e-4,
                            NEGATIVE_RAY),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_losses_matches_jax(case):
    """Every metric and the gradients of both optimizer groups (sdf + color
    + variance; motion) for the same weights, ray_idx and t_rand."""
    s_kw, grad_rtol, color = CASES[case]
    jp, tp = models(0, color)
    nb = _np_batch()
    idx, t_rand = sampling(5)
    rcfg_j, rcfg_t = JRendererConfig(**RCFG), RendererConfig(**RCFG)
    jcfgs = {**JCFGS, "color": JF.ColorConfig(**dataclasses.asdict(tp["color"].cfg))}

    def jf(params):
        return JS.compute_losses(jcfgs, rcfg_j, JS.StepStatic(**s_kw), params,
                                 jax_batch(nb), jnp.asarray(idx),
                                 t_rand=jnp.asarray(t_rand))

    (_, ref_m), ref_g = jax.value_and_grad(jf, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    total, got_m = TS.compute_losses(tp, rcfg_t, TS.StepStatic(**s_kw),
                                     torch_batch(nb), torch.from_numpy(idx).long(),
                                     t_rand=torch.from_numpy(t_rand))
    assert set(got_m) == set(ref_m)
    for k, r in ref_m.items():
        np.testing.assert_allclose(got_m[k].detach().numpy(), np.asarray(r),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    total.backward()
    for k in ("sdf", "color", "variance") + (("motion",) if s_kw["stage1"]
                                               else ()):
        assert_trees_close(grads_as_jax(tp[k]), ref_g[k], grad_rtol,
                           GRAD_ATOL, k)
    if not s_kw["stage1"]:
        assert all(p.grad is None for p in tp["motion"].parameters())


def test_adam_step_matches_jax():
    """One step of the JAX ``build_train_step`` (injected sampling) and of
    the port's: the updated params of every network match."""
    jp, tp = models(0)
    nb = _np_batch()
    idx, t_rand = sampling(6)
    s_kw = static(inject=True)
    jb = jax_batch(nb)
    jb["ray_idx"], jb["t_rand"] = jnp.asarray(idx), jnp.asarray(t_rand)
    jstep = JS.build_train_step(JCFGS, JRendererConfig(**RCFG),
                                JS.StepStatic(**s_kw))
    jstate, _ = jstep(JS.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, jp)), jb, jax.random.PRNGKey(0))
    tb = torch_batch(nb)
    tb["ray_idx"], tb["t_rand"] = torch.from_numpy(idx).long(), torch.from_numpy(t_rand)
    state = TS.init_train_state(tp)
    TS.build_train_step(RendererConfig(**RCFG), TS.StepStatic(**s_kw))(
        state, tb)
    lr = {k: nb["motion_lr"] if k == "motion" else nb["lr"] for k in jp}
    got = X.params_to_jax(state["fields"])
    for k, net in state["fields"].items():
        grads = (grads_as_jax(net) if k != "nerf"
                 else jax.tree_util.tree_map(np.zeros_like, jp[k]))
        flat_r = dict(jax.tree_util.tree_leaves_with_path(jstate["params"][k]))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
        for path, v in jax.tree_util.tree_leaves_with_path(got[k]):
            r, g = np.asarray(flat_r[path]), np.abs(flat_g[path])
            sure = g > 2e-3 * g.max()
            err = np.abs(v - r)
            where = f"{k}{jax.tree_util.keystr(path)}"
            assert np.all(err[sure] <= 1e-4), (where, err[sure].max())
            assert np.all(err <= 2 * lr[k] + 1e-6), (where, err.max())


def test_stage1_loss_descends():
    """15 stage-1 steps on one fixed batch (fixed rays and jitter)."""
    _, tp = models(0)
    state = TS.init_train_state(tp)
    step = TS.build_train_step(RendererConfig(**RCFG),
                               TS.StepStatic(**static(inject=True)))
    tb = torch_batch(_np_batch())
    idx, t_rand = sampling(5)
    tb["ray_idx"], tb["t_rand"] = torch.from_numpy(idx).long(), torch.from_numpy(t_rand)
    metrics = [step(state, tb) for _ in range(15)]
    losses = [float(m["loss"]) for m in metrics]
    assert np.all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    for k in ("loss_rgb", "loss_sdf", "loss_flow_rgb", "sdf_consistency_loss",
              "edge_aware_smoothness_loss"):
        assert np.isfinite(float(metrics[-1][k])), k


def test_nerf_never_updated_and_motion_frozen_in_stage2():
    _, tp = models(0)
    nerf0 = {k: v.clone() for k, v in tp["nerf"].state_dict().items()}
    motion0 = {k: v.clone() for k, v in tp["motion"].state_dict().items()}
    sdf0 = {k: v.clone() for k, v in tp["sdf"].state_dict().items()}
    state = TS.init_train_state(tp)
    tb = torch_batch(_np_batch())
    g = torch.Generator().manual_seed(1)
    m = TS.build_train_step(RendererConfig(**RCFG), TS.StepStatic(
        **static(stage1=False, train_motion=False)))(state, tb, g)
    assert float(m["loss_sdf"]) == 0.0 and float(m["loss_flow_rgb"]) == 0.0
    for k, v in tp["motion"].state_dict().items():
        torch.testing.assert_close(v, motion0[k], rtol=0, atol=0)
    TS.build_train_step(RendererConfig(**RCFG), TS.StepStatic(**static()))(
        state, tb, g)
    for k, v in tp["nerf"].state_dict().items():
        torch.testing.assert_close(v, nerf0[k], rtol=0, atol=0)
    assert any(not torch.equal(v, sdf0[k])
               for k, v in tp["sdf"].state_dict().items())
    assert any(not torch.equal(v, motion0[k])
               for k, v in tp["motion"].state_dict().items())


@pytest.mark.parametrize("h,w,n_points", [(24, 24, 64), (540, 960, 1024)])
def test_sample_patch_indices(h, w, n_points):
    """Whole 4x4 patches, in bounds, no corner drawn twice; at the protocol
    scale too (513,909 possible corners)."""
    g = torch.Generator().manual_seed(3)
    idx = TS.sample_patch_indices(g, h, w, 4, n_points, device="cpu").numpy()
    assert idx.shape == (n_points,)
    assert idx.min() >= 0 and idx.max() < h * w
    corners = idx.reshape(-1, 16)[:, 0]
    assert len(set(corners.tolist())) == n_points // 16
    rows, cols = idx // w, idx % w
    r0, c0 = np.repeat(corners // w, 16), np.repeat(corners % w, 16)
    np.testing.assert_array_equal(rows - r0, np.tile(np.repeat(np.arange(4), 4),
                                                     n_points // 16))
    np.testing.assert_array_equal(cols - c0, np.tile(np.arange(4), n_points // 4))
