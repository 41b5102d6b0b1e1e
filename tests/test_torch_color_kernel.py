"""Port parity for K5, the IDR color MLP with its first-order backward
(``copenerf_torch/ops/kernels/color.py``).

On the CPU ``color_mlp`` takes ``color_plain`` under autograd; its forward
and its VJP to the four inputs (points, view dirs, SDF gradient, feature)
and every weight are held against ``jax.vjp`` of the JAX package's
``get_fused_color`` with the Pallas kernel in interpret mode, at ragged row
counts (the JAX side pads to its tile of 8). ``color_apply`` with and
without the negative ray vector is held against the same JAX kernel on the
negated inputs (the negation stays outside the kernel in both packages).
Weight gradients are compared in the JAX layout. The packed layouts the
CUDA kernels read and write are checked directly and by a pack/unpack
round trip. The CUDA kernels themselves are held against the plain version
on the card (``test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: f32 on both sides, summed in another order over 13-21 rows
through a 4-layer ReLU chain: color and input cotangents 2e-5 absolute,
weight gradients 1e-5 relative to the largest entry of each tensor plus
2e-5 (as ``test_torch_train_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_tpu.ops.pallas.color_kernels import get_fused_color
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.models.mlp import perturb_
from copenerf_torch.ops.kernels import color as CK
from copenerf_torch.ops.kernels import pack
from test_torch_train_kernels import assert_tree_close, grads_as_jax

COLORS = {
    "positive": JF.ColorConfig(d_feature=32, d_hidden=48, n_layers=3,
                               multires_view=2),
    "negative": JF.ColorConfig(d_feature=32, d_hidden=48, n_layers=3,
                               multires_view=2, use_negative_ray_vector=True),
}
ATOL = 2e-5


@pytest.fixture(scope="module")
def nets():
    """The JAX init of each color config (the same weights for both ray
    vectors), perturbed (``perturb_``)."""
    out = {}
    for name, ccfg in COLORS.items():
        jp = {"color": JF.color_init(jax.random.PRNGKey(9), ccfg)}
        tp = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               {"color": TF.ColorConfig(**dataclasses.asdict(ccfg))},
                               device="cpu")
        perturb_(tp, torch.Generator().manual_seed(10))
        out[name] = (X.params_to_jax(tp)["color"], tp["color"])
    return out


def inputs(n, seed, d_feat=32):
    """x (n, 4), unit dirs (n, 3), an SDF gradient (n, 4), a feature."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32) * 0.6
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g = rng.normal(size=(n, 4)).astype(np.float32)
    f = rng.normal(size=(n, d_feat)).astype(np.float32) * 0.5
    return x, d, g, f


@pytest.mark.parametrize("n", [13, 21])
def test_color_forward_matches_pallas(nets, n):
    jp, net = nets["positive"]
    ins = inputs(n, seed=90 + n)
    ref = get_fused_color(COLORS["positive"], tile=8, interpret=True)(
        jp, *map(jnp.asarray, ins))
    with torch.no_grad():
        got = CK.color_mlp(net, *map(torch.from_numpy, ins))
        plain = CK.color_plain(net, *map(torch.from_numpy, ins))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


@pytest.mark.parametrize("n", [13, 21])
def test_color_vjp_matches_pallas(nets, n):
    """x_bar, dirs_bar, grad_bar, feat_bar and every W/b bar."""
    jp, net = nets["positive"]
    ins = inputs(n, seed=100 + n)
    cbar = np.random.default_rng(101).normal(size=(n, 3)).astype(np.float32)
    fn = get_fused_color(COLORS["positive"], tile=8, interpret=True)
    _, vjp = jax.vjp(fn, jp, *map(jnp.asarray, ins))
    ref_p, *ref_ins = vjp(jnp.asarray(cbar))

    for p in net.parameters():
        p.grad = None
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    CK.color_mlp(net, *ts).backward(torch.from_numpy(cbar))
    for name, t, r in zip(("x", "dirs", "grad", "feat"), ts, ref_ins):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL, err_msg=f"{name}_bar")
    assert_tree_close(grads_as_jax(net), ref_p, "color")


@pytest.mark.parametrize("ray", sorted(COLORS))
def test_color_apply_ray_vector_matches_pallas(nets, ray):
    """``color_apply`` (points, normals, view dirs, features) against the
    JAX kernel on (points, -dirs, -normals, features) under the negative ray
    vector and on the inputs as they are otherwise: color and every input
    cotangent."""
    jp, net = nets[ray]
    x, d, g, f = inputs(17, seed=110)
    cbar = np.random.default_rng(111).normal(size=(17, 3)).astype(np.float32)
    sign = -1.0 if COLORS[ray].use_negative_ray_vector else 1.0
    fn = get_fused_color(COLORS[ray], tile=8, interpret=True)

    def jf(x_, g_, d_, f_):
        return fn(jp, x_, sign * d_, sign * g_, f_)

    ref, vjp = jax.vjp(jf, *map(jnp.asarray, (x, g, d, f)))
    ref_ins = vjp(jnp.asarray(cbar))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, d, f)]
    got = TF.color_apply(net, *ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    got.backward(torch.from_numpy(cbar))
    for name, t, r in zip(("points", "normals", "dirs", "feat"), ts, ref_ins):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL, err_msg=f"{ray} {name}_bar")


@pytest.mark.parametrize("width", ["small", "full"])
def test_color_grad_layout_round_trip(width):
    """pack then unpack of the K5-bwd gradient buffer is the identity,
    through the layer-0 permutation and its padding column, which stays
    zero; K1-bwd's buffer holds the same layout after its SDF part."""
    ccfg = (TF.ColorConfig() if width == "full"
            else TF.ColorConfig(**dataclasses.asdict(COLORS["positive"])))
    g = torch.Generator().manual_seed(4)
    bars = [(torch.randn(o, i, generator=g), torch.randn(o, generator=g))
            for o, i in pack._layer_shapes(ccfg)]
    offs, size = pack.color_grad_layout(ccfg)
    buf = pack.pack_color_grads(bars, ccfg)
    assert buf.numel() == size
    k0 = pack.color_k0(ccfg)
    g0 = buf[offs["gwc"][0]:offs["gwc"][0] + ccfg.d_hidden * k0]
    assert torch.all(g0.view(ccfg.d_hidden, k0)[:, ccfg.dims[0]:] == 0)
    for (gw, gb), (w, b) in zip(pack.unpack_color_grads(buf, offs, ccfg), bars):
        torch.testing.assert_close(gw, w, rtol=0, atol=0)
        torch.testing.assert_close(gb, b, rtol=0, atol=0)
    scfg = TF.SDFConfig(d_out=ccfg.d_feature + 1)
    rc_offs, rc_size = pack.rendercore_grad_layout(scfg, ccfg)
    base = rc_size - size
    assert [o - base for o in rc_offs["gwc"]] == offs["gwc"]
    assert [o - base for o in rc_offs["gbc"]] == offs["gbc"]


def test_color_pack_layout(nets):
    """K5's pack: each hidden layer as the wgmma core's B both ways
    (``wcp``: B = W^T, ``wctp``: B = W; layer 0 with its inputs in the
    kernel's order, padded to k0), as ``pack.wg_pack_b`` packs one matrix
    (``test_torch_wgmma_emulation.py`` reads that layout back through the
    descriptor); the head W (in, out) and W (out, in); b per layer."""
    _, net = nets["positive"]
    P, offs = pack.pack_color(net)
    ccfg = net.cfg
    layers = pack.effective_layers(net)
    assert pack.color_k0(ccfg) <= 256 and "wct0tp" not in offs
    with torch.no_grad():
        for l, (w, b) in enumerate(layers):
            o, i = w.shape
            want = pack.color_kernel_inputs(w, ccfg) if l == 0 else w
            if l < len(layers) - 1:
                for name, bt in (("wcp", want), ("wctp", want.t())):
                    ref = pack.wg_pack_b(bt)
                    got = P[offs[name][l]:offs[name][l] + ref.numel()]
                    torch.testing.assert_close(got, ref, rtol=0, atol=0)
            else:
                wct = P[offs["wct_last"]:offs["wct_last"] + o * i].view(o, i)
                wc = P[offs["wc_last"]:offs["wc_last"] + o * i].view(i, o)
                torch.testing.assert_close(wct, want, rtol=0, atol=0)
                torch.testing.assert_close(wc, want.t(), rtol=0, atol=0)
            torch.testing.assert_close(P[offs["bc"][l]:offs["bc"][l] + o], b,
                                       rtol=0, atol=0)


def test_color_geometry_checks():
    """K5 takes either ray vector; K1 the positive one alone."""
    ccfg = TF.ColorConfig(use_negative_ray_vector=True)
    pack.check_color_mlp_geometry(ccfg)
    with pytest.raises(ValueError, match="positive ray vector"):
        pack.check_color_geometry(TF.SDFConfig(), ccfg)
    with pytest.raises(ValueError, match="only mode idr"):
        pack.check_color_mlp_geometry(TF.ColorConfig(mode="no_normal", d_in=7,
                                                     multires_view=0))


def test_color_cuda_entries_refuse_cpu_tensors(nets):
    """The K5 launchers never compute on a CPU tensor: they raise."""
    _, net = nets["positive"]
    ts = list(map(torch.from_numpy, inputs(8, seed=120)))
    with torch.no_grad():
        packed = pack.pack_color(net)
        with pytest.raises(ValueError, match="CUDA tensor"):
            CK.color_fwd_cuda(net, *ts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CK.color_bwd_cuda(net.cfg, packed, *ts, torch.zeros(8, 3))


def test_color_feature_rows_may_be_a_head_slice():
    """The feature is taken at its row stride: a column slice of the
    257-wide SDF head passes as a view; rows without unit column stride are
    copied."""
    head = torch.arange(5 * 257, dtype=torch.float32).view(5, 257)
    rows = CK._rows(head[:, 1:], 256)
    assert rows.data_ptr() == head[:, 1:].data_ptr() and rows.stride() == (257, 1)
    t = torch.arange(5 * 256, dtype=torch.float32).view(256, 5).t()
    assert CK._rows(t, 256).is_contiguous()
