"""Port parity for the backward kernels of the training slice: K1-bwd (the
render core's second-order backward) and K3 (the differentiable SDF value).

On the CPU each routed entry takes its kernel's plain version under
autograd; these VJPs are held against ``jax.vjp`` of the JAX package's
Pallas kernels in interpret mode, at a ragged row count (the JAX side pads
to its tile). Weight gradients are compared in the JAX layout (``v``
(in, out), ``g``, ``b``). The packed gradient layout the CUDA kernels write
is checked by a pack/unpack round trip. The CUDA kernels themselves are held
against these plain versions on the card (``test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances: f32 on both sides, summed in another order over 13-21 rows and
a second-order chain of 5 layers: inputs' cotangents 2e-5 absolute, weight
gradients 1e-5 relative to the largest entry of each tensor plus 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_tpu.ops.pallas.rendercore_kernels import get_fused_rendercore
from copenerf_tpu.ops.pallas.sdf_kernels import get_fused_ops
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.models.mlp import perturb_
from copenerf_torch.ops.kernels import pack
from copenerf_torch.ops.kernels import rendercore as RC
from copenerf_torch.ops.kernels import sdf_value_diff as SVD

SDF = JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                   multires=3, bias=0.5, scale=1.3)
COLOR = JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                       multires_view=2)
ATOL = 2e-5


@pytest.fixture(scope="module")
def nets():
    """The JAX init, perturbed (``perturb_``) so that the PE columns and the
    head's column order are visible to every check."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = {"sdf": JF.sdf_init(k1, SDF), "color": JF.color_init(k2, COLOR)}
    cfgs = {"sdf": TF.SDFConfig(**dataclasses.asdict(SDF)),
            "color": TF.ColorConfig(**dataclasses.asdict(COLOR))}
    tp = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfgs,
                           device="cpu")
    perturb_(tp, torch.Generator().manual_seed(5))
    return X.params_to_jax(tp), tp


def rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32) * 0.6
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def grads_as_jax(net) -> dict:
    """``.grad`` of every layer of ``net`` in the JAX layout."""
    out = {}
    for name, layer in net.layers.items():
        if hasattr(layer, "v"):
            out[name] = {"v": layer.v.grad.numpy().T, "g": layer.g.grad.numpy(),
                         "b": layer.b.grad.numpy()}
        else:
            out[name] = {"w": layer.w.grad.numpy().T, "b": layer.b.grad.numpy()}
    return out


def assert_tree_close(got: dict, ref: dict, what: str):
    for lname, leaves in ref.items():
        for k, r in leaves.items():
            r = np.asarray(r)
            tol = 1e-5 * np.abs(r).max() + ATOL
            np.testing.assert_allclose(got[lname][k], r, rtol=0, atol=tol,
                                       err_msg=f"{what} {lname}.{k}")


def _zero_grads(*nets):
    for net in nets:
        for p in net.parameters():
            p.grad = None


CHANNELS = {"sbar": (1, 0, 0), "gbar": (0, 1, 0), "cbar": (0, 0, 1),
            "all": (1, 1, 1)}


@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_rendercore_vjp_matches_pallas(nets, channel):
    """x_bar, dirs_bar and every W/b bar of both nets for each cotangent
    channel alone and all three together, at 13 rows (JAX tile 8)."""
    jp, tp = nets
    n = 13
    x, d = rows(n, seed=21)
    rng = np.random.default_rng(22)
    on = CHANNELS[channel]
    cots = [rng.normal(size=(n, w)).astype(np.float32) * m
            for w, m in zip((1, 4, 3), on)]
    fn = get_fused_rendercore(SDF, COLOR, tile_fwd=8, tile_bwd=8,
                              interpret=True)
    _, vjp = jax.vjp(fn, jp["sdf"], jp["color"], jnp.asarray(x),
                     jnp.asarray(d))
    ref_sdf, ref_color, ref_x, ref_d = vjp(tuple(map(jnp.asarray, cots)))

    sdf_net, color_net = tp["sdf"], tp["color"]
    _zero_grads(sdf_net, color_net)
    xt = torch.from_numpy(x).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    out = RC.rendercore_fwd(sdf_net, color_net, xt, dt)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cots])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), rtol=0,
                               atol=ATOL, err_msg="x_bar")
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(ref_d), rtol=0,
                               atol=ATOL, err_msg="dirs_bar")
    assert_tree_close(grads_as_jax(sdf_net), ref_sdf, f"{channel} sdf")
    assert_tree_close(grads_as_jax(color_net), ref_color, f"{channel} color")


@pytest.mark.parametrize("n", [11, 21])
def test_sdf_value_diff_vjp_matches_pallas(nets, n):
    jp, tp = nets
    x, _ = rows(n, seed=30 + n)
    obar = np.random.default_rng(31).normal(size=(n,)).astype(np.float32)
    ops = get_fused_ops(SDF, tile=8, interpret=True)
    val, vjp = jax.vjp(ops.value_diff, jp["sdf"], jnp.asarray(x))
    ref_p, ref_x = vjp(jnp.asarray(obar))

    net = tp["sdf"]
    _zero_grads(net)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TF.sdf_scalar(net, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(val), rtol=0,
                               atol=ATOL)
    got.backward(torch.from_numpy(obar))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), rtol=0,
                               atol=ATOL, err_msg="x_bar")
    assert_tree_close(grads_as_jax(net), ref_p, "value_diff")


def test_grad_color_cons_composes_k1_and_k3(nets):
    """The consistency query is the render-core op plus ``sdf_scalar`` at
    y; its gradient is the sum of theirs."""
    _, tp = nets
    x, d = rows(9, seed=40)
    y, _ = rows(9, seed=41)
    sdf_net, color_net = tp["sdf"], tp["color"]
    got = TF.sdf_grad_color_cons(sdf_net, color_net, *map(torch.from_numpy,
                                                          (x, d, y)))
    ref = RC.rendercore_fwd_plain(sdf_net, color_net, torch.from_numpy(x),
                                  torch.from_numpy(d))
    for g, r in zip(got[:3], ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    torch.testing.assert_close(got[3], sdf_net(torch.from_numpy(y))[..., 0],
                               rtol=0, atol=0)


def _random_bars(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = pack._layer_shapes(cfg)
    return [(torch.randn(o, i, generator=g), torch.randn(o, generator=g))
            for o, i in shapes]


@pytest.mark.parametrize("width", ["small", "full"])
def test_grad_layout_round_trip(width):
    """pack then unpack of the K1-bwd gradient buffer is the identity,
    through the color layer-0 permutation and its padding column; the
    ``gw_last0`` slot adds to row 0 of the last SDF layer."""
    if width == "full":
        scfg, ccfg = TF.SDFConfig(), TF.ColorConfig()
    else:
        scfg = TF.SDFConfig(**dataclasses.asdict(SDF))
        ccfg = TF.ColorConfig(**dataclasses.asdict(COLOR))
    sdf_bars, color_bars = _random_bars(scfg, 1), _random_bars(ccfg, 2)
    offs, size = pack.rendercore_grad_layout(scfg, ccfg)
    buf = pack.pack_rendercore_grads(sdf_bars, color_bars, scfg, ccfg)
    assert buf.numel() == size
    k0 = pack.color_k0(ccfg)
    assert k0 > ccfg.dims[0] or width == "small"
    # The padding column of the kernel's color layer 0 is zero.
    g0 = buf[offs["gwc"][0]:offs["gwc"][0] + ccfg.d_hidden * k0]
    assert torch.all(g0.view(ccfg.d_hidden, k0)[:, ccfg.dims[0]:] == 0)
    got_s, got_c = pack.unpack_rendercore_grads(buf, offs, scfg, ccfg)
    for (gw, gb), (w, b) in zip(got_s + got_c, sdf_bars + color_bars):
        torch.testing.assert_close(gw, w, rtol=0, atol=0)
        torch.testing.assert_close(gb, b, rtol=0, atol=0)
    extra = torch.arange(scfg.d_hidden, dtype=torch.float32)
    buf[offs["gw_last0"]:offs["gw_last0"] + scfg.d_hidden] = extra
    got_s, _ = pack.unpack_rendercore_grads(buf, offs, scfg, ccfg)
    torch.testing.assert_close(got_s[-1][0][0], sdf_bars[-1][0][0] + extra)
    torch.testing.assert_close(got_s[-1][0][1:], sdf_bars[-1][0][1:])


def test_value_grad_layout_pads_the_head():
    """K3-bwd's buffer holds row 0 of the last layer; unpack pads the rest
    of the (d_out, hidden) gradient with zeros, as the JAX kernel does."""
    scfg = TF.SDFConfig(**dataclasses.asdict(SDF))
    offs, size = pack.sdf_value_grad_layout(scfg)
    buf = torch.arange(size, dtype=torch.float32)
    bars = pack.unpack_sdf_value_grads(buf, offs, scfg)
    shapes = pack._layer_shapes(scfg)
    assert [tuple(w.shape) for w, _ in bars] == shapes
    w_last, b_last = bars[-1]
    o = offs["gw"][-1]
    torch.testing.assert_close(w_last[0], buf[o:o + scfg.d_hidden])
    assert torch.all(w_last[1:] == 0) and torch.all(b_last[1:] == 0)


def test_backward_pack_layout(nets):
    """The backward's extra weights, as wgmma B split into TF32 hi and lo:
    ``wctp[l]`` is each hidden color layer's (out, in) effective weight
    (layer 0 in the kernel's input order, padded: its columns < 256, and
    ``wct0tp`` the rest where k0 > 256); ``wftp`` the last SDF layer's
    feature rows; the color head plain, ``wct_last`` (out, in) and
    ``wc_last`` its transpose."""
    _, tp = nets
    P, offs = pack.pack_rendercore(tp["sdf"], tp["color"])
    ccfg = tp["color"].cfg
    k0 = pack.color_k0(ccfg)

    def same_split(off, b):
        hi, lo = pack.wg_unpack_b(P[off:], *b.shape)
        torch.testing.assert_close(hi, pack.tf32_rna(b), rtol=0, atol=0)
        torch.testing.assert_close(lo, pack.tf32_rna(b - hi), rtol=0, atol=0)

    with torch.no_grad():
        layers = pack.effective_layers(tp["color"])
        for l, (w, _) in enumerate(layers[:-1]):
            want = pack.color_kernel_inputs(w, ccfg) if l == 0 else w
            same_split(offs["wctp"][l], want[:, :256])
            if want.shape[1] > 256:
                same_split(offs["wct0tp"], want[:, 256:])
        assert ("wct0tp" in offs) == (k0 > 256)
        w = layers[-1][0]
        o, i = w.shape
        torch.testing.assert_close(P[offs["wct_last"]:offs["wct_last"] + o * i].view(o, i),
                                   w, rtol=0, atol=0)
        torch.testing.assert_close(P[offs["wc_last"]:offs["wc_last"] + o * i].view(i, o),
                                   w.t(), rtol=0, atol=0)
        w_last = pack.effective_layers(tp["sdf"])[-1][0]
        same_split(offs["wftp"], w_last[1:])


def test_backward_cuda_entries_refuse_cpu_tensors(nets):
    """The backward launchers never compute on a CPU tensor: they raise."""
    _, tp = nets
    x, d = rows(8, seed=50)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    scfg, ccfg = tp["sdf"].cfg, tp["color"].cfg
    with torch.no_grad():
        packed = pack.pack_rendercore(tp["sdf"], tp["color"])
        vpacked = pack.pack_sdf_value_layers(pack.effective_layers(tp["sdf"]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        RC.rendercore_bwd_cuda(scfg, ccfg, packed, xt, dt, torch.zeros(8, 1),
                               torch.zeros(8, 4), torch.zeros(8, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        SVD.sdf_value_bwd_cuda(scfg, vpacked, xt, torch.zeros(8))
