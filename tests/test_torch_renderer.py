"""Port parity for rays, sampling and the renderer (``copenerf_torch.ops``)
against the JAX package, at small widths with exchanged weights and numpy
inputs. On the CPU the renderer's field queries take the kernels' plain
versions. Tolerances: f32 rounding. In ``render`` the importance chain's
fixed inv_s (up to 512) amplifies last-bit SDF differences into the
resampled z positions (measured up to 1.2e-4 on these inputs), so the
per-sample outputs get 3e-4 and the composited ones 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_tpu.ops import rays as JR
from copenerf_tpu.ops import renderer as JRen
from copenerf_tpu.ops import sampling as JS
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.ops import rays as TR
from copenerf_torch.ops import renderer as TRen
from copenerf_torch.ops import sampling as TS

SDF = JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                   multires=3, bias=0.5, scale=1.0)
COLOR = JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                       multires_view=2)
VAR = JF.VarianceConfig(init_val=0.3)
RCFG = dict(n_samples=16, n_importance=16, up_sample_steps=4)
COMPOSITED = {"color_fine", "depth_pred", "weighted_z_vals", "s_val",
              "weight_sum"}


def render_tol(key):
    return 2e-5 if key in COMPOSITED else 3e-4


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref, atol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol, err_msg=name)


def _bins_weights(seed, b=7, s=12):
    r = rng(seed)
    bins = np.sort(r.uniform(0.5, 3.0, size=(b, s)), -1).astype(np.float32)
    w = r.uniform(0, 1, size=(b, s - 1)).astype(np.float32) ** 3
    return bins, w


def test_sample_pdf_and_transmittance():
    bins, w = _bins_weights(0)
    close(TS.sample_pdf(t(bins), t(w), 9),
          JS.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 9), 1e-5)
    wf = np.concatenate([w, w[:, :1]], -1)
    close(TS.sample_pdf(t(bins), t(wf), 5, prepend_zero=False),
          JS.sample_pdf(jnp.asarray(bins), jnp.asarray(wf), 5,
                        prepend_zero=False), 1e-5)
    alpha = rng(1).uniform(0, 1, size=(5, 9)).astype(np.float32)
    close(TS._exclusive_transmittance(t(alpha)),
          JS._exclusive_transmittance(jnp.asarray(alpha)), 1e-6)


@pytest.mark.parametrize("naive", [False, True])
def test_up_sample(naive):
    bins, _ = _bins_weights(2, s=16)
    sdf = (rng(3).normal(size=bins.shape) * 0.3).astype(np.float32)
    ro = np.zeros((bins.shape[0], 3), np.float32)
    fn_t = TS.up_sample_naive if naive else TS.up_sample
    fn_j = JS.up_sample_naive if naive else JS.up_sample
    for inv_s in (64.0, 512.0):
        close(fn_t(t(ro), t(ro), t(bins), t(sdf), 4, inv_s),
              fn_j(jnp.asarray(ro), jnp.asarray(ro), jnp.asarray(bins),
                   jnp.asarray(sdf), 4, inv_s), 1e-5)


def test_cat_z_vals():
    r = rng(4)
    z = np.sort(r.uniform(0, 1, (6, 8)), -1).astype(np.float32)
    zn = np.sort(r.uniform(0, 1, (6, 4)), -1).astype(np.float32)
    s, sn = (r.normal(size=(6, 8)).astype(np.float32),
             r.normal(size=(6, 4)).astype(np.float32))
    zt, st, _ = TS.cat_z_vals(t(z), t(zn), t(s), t(sn))
    zj, sj, _ = JS.cat_z_vals(*map(jnp.asarray, (z, zn, s, sn)))
    close(zt, zj, 0)
    close(st, sj, 0)
    zt, st, _ = TS.cat_z_vals(t(z), t(zn), t(s), None)
    zj, sj, _ = JS.cat_z_vals(*map(jnp.asarray, (z, zn, s)), None)
    close(zt, zj, 0)
    close(st, sj, 0)


def test_rays():
    loc_t, sc_t = TR.arange_pixels((5, 7))
    loc_j, sc_j = JR.arange_pixels((5, 7))
    np.testing.assert_array_equal(loc_t, loc_j)
    np.testing.assert_array_equal(sc_t, sc_j)
    K = np.array([[1.2, 0, 0, 0], [0, -1.6, 0, 0], [0, 0, -1, 0],
                  [0, 0, 0, 1]], np.float32)
    W = np.eye(4, dtype=np.float32)
    W[:3, 3] = [0.1, -0.2, -2.0]
    S = np.diag([1.1, 1.1, 1.1, 1.0]).astype(np.float32)
    got = TR.rays_from_pixels(t(sc_t), t(K), t(W), t(S))
    ref = JR.rays_from_pixels(*map(jnp.asarray, (sc_j, K, W, S)))
    for g, r_ in zip(got, ref):
        close(g, r_, 1e-5)
    near, far = TR.near_far_from_depth_range(3, (0.5, 4.0), device="cpu")
    nj, fj = JR.near_far_from_depth_range(3, (0.5, 4.0))
    close(near, nj, 0)
    close(far, fj, 0)


@pytest.fixture(scope="module")
def models():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    jp = {"sdf": JF.sdf_init(k1, SDF), "color": JF.color_init(k2, COLOR),
          "variance": JF.variance_init(VAR)}
    cfgs = {"sdf": TF.SDFConfig(**dataclasses.asdict(SDF)),
            "color": TF.ColorConfig(**dataclasses.asdict(COLOR)),
            "variance": TF.VarianceConfig(**dataclasses.asdict(VAR))}
    tp = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfgs,
                           device="cpu")
    return ({"sdf": SDF, "color": COLOR, "variance": VAR}, jp, tp)


def _rays(n, seed):
    r = rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 2.0]], np.float32), (n, 1))
    ro = ro + r.normal(size=(n, 3)).astype(np.float32) * 0.05
    target = r.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    rd = target - ro
    norm = np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, (rd / norm).astype(np.float32), (norm / 2).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_render_every_output_key(models, train):
    cfgs, jp, tp = models
    n = 24
    ro, rd, rn = _rays(n, seed=5)
    near = np.full((n, 1), 0.8, np.float32)
    far = np.full((n, 1), 3.2, np.float32)
    t_rand = rng(6).uniform(size=(n, RCFG["n_samples"])).astype(np.float32)
    kw = dict(cos_anneal_ratio=0.7, train=train)
    ref = JRen.render(cfgs, jp, *map(jnp.asarray, (ro, rd, rn)), 0.1,
                      jnp.asarray(near), jnp.asarray(far),
                      rcfg=JRen.RendererConfig(**RCFG),
                      t_rand=jnp.asarray(t_rand) if train else None, **kw)
    with torch.no_grad():
        got = TRen.render(tp, t(ro), t(rd), t(rn), 0.1, t(near), t(far),
                          rcfg=TRen.RendererConfig(**RCFG),
                          t_rand=t(t_rand) if train else None, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        close(got[k], ref[k], render_tol(k), k)


COMPOSED = {  # the composed field path (K4 + K5 on the card)
    "negative_ray": JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                                   multires_view=2,
                                   use_negative_ray_vector=True),
    "no_normal": JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                                mode="no_normal", d_in=7, multires_view=0),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("color", sorted(COMPOSED))
def test_render_composed_color_configs(models, color, train):
    """Every output key of ``render`` with a color config that composes
    the SDF outgrad and the color MLP instead of the render-core op."""
    cfgs, jp, tp = models
    ccfg = COMPOSED[color]
    jc = JF.color_init(jax.random.PRNGKey(4), ccfg)
    cfgs = {**cfgs, "color": ccfg}
    jp = {**jp, "color": jc}
    tp = {**tp, **X.params_from_jax(
        {"color": jax.tree_util.tree_map(np.asarray, jc)},
        {"color": TF.ColorConfig(**dataclasses.asdict(ccfg))}, device="cpu")}
    n = 24
    ro, rd, rn = _rays(n, seed=11)
    near = np.full((n, 1), 0.8, np.float32)
    far = np.full((n, 1), 3.2, np.float32)
    t_rand = rng(12).uniform(size=(n, RCFG["n_samples"])).astype(np.float32)
    kw = dict(cos_anneal_ratio=0.7, train=train)
    ref = JRen.render(cfgs, jp, *map(jnp.asarray, (ro, rd, rn)), 0.1,
                      jnp.asarray(near), jnp.asarray(far),
                      rcfg=JRen.RendererConfig(**RCFG),
                      t_rand=jnp.asarray(t_rand) if train else None, **kw)
    with torch.no_grad():
        got = TRen.render(tp, t(ro), t(rd), t(rn), 0.1, t(near), t(far),
                          rcfg=TRen.RendererConfig(**RCFG),
                          t_rand=t(t_rand) if train else None, **kw)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], render_tol(k), f"{color} {k}")


def test_render_without_importance(models):
    cfgs, jp, tp = models
    n = 9
    ro, rd, rn = _rays(n, seed=8)
    near = np.full((n, 1), 0.8, np.float32)
    far = np.full((n, 1), 3.2, np.float32)
    ref = JRen.render(cfgs, jp, *map(jnp.asarray, (ro, rd, rn)), -0.2,
                      jnp.asarray(near), jnp.asarray(far),
                      rcfg=JRen.RendererConfig(**RCFG), cos_anneal_ratio=1.0,
                      use_importance=False, train=False)
    with torch.no_grad():
        got = TRen.render(tp, t(ro), t(rd), t(rn), -0.2, t(near), t(far),
                          rcfg=TRen.RendererConfig(**RCFG),
                          cos_anneal_ratio=1.0, use_importance=False,
                          train=False)
    for k in ("color_fine", "depth_pred", "weights", "normals"):
        close(got[k], ref[k], render_tol(k), k)


def test_render_core_outside():
    nerf = JF.NerfConfig(D=4, W=32, multires=3, multires_view=2, skips=(2,))
    jp = JF.nerf_init(jax.random.PRNGKey(3), nerf)
    net = X.params_from_jax({"nerf": jax.tree_util.tree_map(np.asarray, jp)},
                            {"nerf": TF.NerfConfig(**dataclasses.asdict(nerf))},
                            device="cpu")["nerf"]
    n = 6
    ro, rd, _ = _rays(n, seed=9)
    z = np.sort(rng(10).uniform(2.0, 6.0, size=(n, 5)), -1).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    ref = JRen.render_core_outside(nerf, jp, *map(jnp.asarray, (ro, rd, z)),
                                   0.3, background_rgb=jnp.asarray(bg))
    with torch.no_grad():
        got = TRen.render_core_outside(net, t(ro), t(rd), t(z), 0.3,
                                       background_rgb=t(bg))
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], 2e-5, k)
