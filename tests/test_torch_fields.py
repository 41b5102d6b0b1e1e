"""Port parity: the field networks of ``copenerf_torch`` against the JAX
package at small widths, with the same weights (through the exchange) and
the same numpy inputs. The JAX side runs at HIGHEST matmul precision
(conftest); both sides compute in f32, so the tolerances are f32 rounding
over a few layers."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.models.mlp import perturb_

SDF = JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                   multires=3, bias=0.5, scale=1.3)
COLOR = JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                       multires_view=2)
MOTION = JF.MotionConfig(d_hidden=32, n_layers=4, skip_in=(2,), multires=3,
                         scale=0.7)
NERF = JF.NerfConfig(D=4, W=32, multires=3, multires_view=2, skips=(2,))
VAR = JF.VarianceConfig(init_val=0.3)
ATOL = 2e-5


def _cfg(jcfg, tcls):
    return tcls(**dataclasses.asdict(jcfg))


def tcfgs(color=COLOR):
    return {"sdf": _cfg(SDF, TF.SDFConfig), "color": _cfg(color, TF.ColorConfig),
            "motion": _cfg(MOTION, TF.MotionConfig),
            "nerf": _cfg(NERF, TF.NerfConfig),
            "variance": _cfg(VAR, TF.VarianceConfig)}


def jax_params(color=COLOR):
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    return {"sdf": JF.sdf_init(k[0], SDF), "color": JF.color_init(k[1], color),
            "motion": JF.motion_init(k[2], MOTION),
            "nerf": JF.nerf_init(k[3], NERF),
            "variance": JF.variance_init(VAR)}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def both():
    """The JAX init, perturbed (``perturb_``) so that no weight is zero or
    repeated: the geometric init's zero PE columns would hide the PE."""
    nets = X.params_from_jax(to_numpy(jax_params()), tcfgs(), device="cpu")
    perturb_(nets, torch.Generator().manual_seed(0))
    return X.params_to_jax(nets), nets


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_sdf_forward_and_gradient(both):
    jp, nets = both
    x = rnd(37, 4)
    np.testing.assert_allclose(
        nets["sdf"](t(x)).detach().numpy(),
        np.asarray(JF.sdf_apply(SDF, jp["sdf"], jnp.asarray(x))),
        rtol=0, atol=ATOL)
    out_j, g_j = JF.sdf_with_gradient(SDF, jp["sdf"], jnp.asarray(x))
    out_t, g_t = TF.sdf_with_gradient(nets["sdf"], t(x))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=ATOL)


def test_sdf_output_and_gradient_no_grad_mode(both):
    jp, nets = both
    x = rnd(11, 4, seed=1)
    with torch.no_grad():
        out_t, g_t = TF.sdf_output_and_gradient(nets["sdf"], t(x))
    out_j, g_j = JF.sdf_output_and_gradient(SDF, jp["sdf"], jnp.asarray(x))
    assert not out_t.requires_grad and not g_t.requires_grad
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["idr", "no_view_dir", "no_normal"])
def test_color_modes(mode):
    # Without view-dir PE the input widths add up for every mode.
    d_in = {"idr": 11, "no_view_dir": 8, "no_normal": 7}[mode]
    color = dataclasses.replace(COLOR, mode=mode, d_in=d_in,
                                multires_view=2 if mode == "idr" else 0)
    jp = jax_params(color)
    nets = X.params_from_jax(to_numpy({"color": jp["color"]}),
                             tcfgs(color), device="cpu")
    pts, nrm, dirs, feat = (rnd(9, 4, seed=2), rnd(9, 4, seed=3),
                            rnd(9, 3, seed=4), rnd(9, 32, seed=5))
    ref = JF.color_apply(color, jp["color"], *map(jnp.asarray,
                                                  (pts, nrm, dirs, feat)))
    got = nets["color"](t(pts), t(nrm), t(dirs), t(feat))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)


def test_motion_nerf_variance(both):
    jp, nets = both
    tt = rnd(13, 1, seed=6)
    w_j, v_j = JF.motion_apply(MOTION, jp["motion"], jnp.asarray(tt))
    w_t, v_t = nets["motion"](t(tt))
    np.testing.assert_allclose(w_t.detach().numpy(), w_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(v_t.detach().numpy(), v_j, rtol=0, atol=ATOL)
    pts, dirs = rnd(7, 4, seed=7), rnd(7, 3, seed=8)
    a_j, c_j = JF.nerf_apply(NERF, jp["nerf"], jnp.asarray(pts),
                             jnp.asarray(dirs))
    a_t, c_t = nets["nerf"](t(pts), t(dirs))
    np.testing.assert_allclose(a_t.detach().numpy(), a_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(c_t.detach().numpy(), c_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        TF.variance_inv_s(nets["variance"]).item(),
        float(JF.variance_inv_s(jp["variance"])), rtol=1e-6)


def test_exchange_round_trip(both):
    jp, _ = both
    back = X.params_to_jax(X.params_from_jax(jp, tcfgs(), device="cpu"))
    ref = to_numpy(jp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_b) == len(flat_r)
    for path, leaf in flat_b:
        np.testing.assert_array_equal(leaf, flat_r[path])


def test_geometric_init_structure():
    """The port's own init has the JAX init's structure: the PE columns of
    layer 0 and of the skip layer start at zero, weight norm g = ||v||, and
    the head bias is -bias."""
    net = TF.SDFNetwork(_cfg(SDF, TF.SDFConfig), torch.Generator().manual_seed(0))
    d0 = SDF.dims[0]
    v0 = net.layers["lin0"].v.detach()
    assert torch.all(v0[:, SDF.d_in:] == 0) and torch.any(v0[:, :SDF.d_in] != 0)
    vs = net.layers["lin2"].v.detach()
    assert torch.all(vs[:, vs.shape[1] - (d0 - SDF.d_in):] == 0)
    last = net.layers[f"lin{len(SDF.dims) - 2}"]
    assert torch.allclose(last.b.detach(), torch.full_like(last.b, -SDF.bias))
    for layer in net.layers.values():
        torch.testing.assert_close(layer.g.detach(),
                                   torch.linalg.norm(layer.v.detach(), dim=1))
    jshape = {k: tuple(np.asarray(p["v"]).shape[::-1])
              for k, p in JF.sdf_init(jax.random.PRNGKey(0), SDF).items()}
    assert {k: tuple(l.v.shape) for k, l in net.layers.items()} == jshape


def test_configs_from_cfg_full_width():
    from copenerf_torch.config import load_config
    from copenerf_tpu.config.loader import load_config as jload

    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "default.yaml")
    tc = TF.configs_from_cfg(load_config(path))
    jc = JF.configs_from_cfg(jload(path))
    for k in jc:
        assert dataclasses.asdict(tc[k]) == dataclasses.asdict(jc[k])
    assert tc["sdf"].dims == (52,) + (256,) * 8 + (257,)
    assert tc["color"].dims[0] == 291
