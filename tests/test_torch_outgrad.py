"""Port parity for K4, the SDF output and its input gradient with a
second-order backward (``copenerf_torch/ops/kernels/outgrad.py``).

On the CPU ``sdf_output_and_gradient`` takes ``sdf_outgrad_plain`` under
autograd; its forward and its VJP (for the head's cotangent obar alone, the
gradient's cotangent gbar alone, and both) are held against ``jax.vjp`` of
the JAX package's ``get_fused_ops(...).outgrad`` with the Pallas kernels in
interpret mode, at ragged row counts (the JAX side pads to its tile of 8).
Weight gradients are compared in the JAX layout. The packed gradient layout
the CUDA kernel writes is checked by a pack/unpack round trip. The CUDA
kernels themselves are held against the plain version on the card
(``test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: f32 on both sides, summed in another order over 13-21 rows and
a second-order chain of 5 layers: outputs and input cotangents 2e-5
absolute, weight gradients 1e-5 relative to the largest entry of each
tensor plus 2e-5 (as ``test_torch_train_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_tpu.ops.pallas.sdf_kernels import get_fused_ops
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.models.mlp import perturb_
from copenerf_torch.ops.kernels import build, emulate
from copenerf_torch.ops.kernels import color as CK
from copenerf_torch.ops.kernels import outgrad as OG
from copenerf_torch.ops.kernels import pack
from copenerf_torch.ops.kernels import rendercore as RC
from copenerf_torch.ops.kernels import sdf_value as SV
from copenerf_torch.ops.kernels import sdf_value_diff as SVD
from test_torch_train_kernels import assert_tree_close, grads_as_jax, rows

SDF = JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                   multires=3, bias=0.5, scale=1.3)
ATOL = 2e-5


@pytest.fixture(scope="module")
def nets():
    """The JAX init, perturbed (``perturb_``) so that the PE columns and the
    head's column order are visible to every check."""
    jp = {"sdf": JF.sdf_init(jax.random.PRNGKey(7), SDF)}
    cfgs = {"sdf": TF.SDFConfig(**dataclasses.asdict(SDF))}
    tp = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfgs,
                           device="cpu")
    perturb_(tp, torch.Generator().manual_seed(8))
    return X.params_to_jax(tp), tp


@pytest.mark.parametrize("n", [13, 21])
def test_outgrad_forward_matches_pallas(nets, n):
    jp, tp = nets
    x, _ = rows(n, seed=60 + n)
    ref_out, ref_grad = get_fused_ops(SDF, tile=8, interpret=True).outgrad(
        jp["sdf"], jnp.asarray(x))
    with torch.no_grad():
        out, grad = TF.sdf_output_and_gradient(tp["sdf"], torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=ATOL, err_msg="out")
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=0,
                               atol=ATOL, err_msg="grad")
    with torch.no_grad():
        plain = OG.sdf_outgrad_plain(tp["sdf"], torch.from_numpy(x))
    for a, b in zip(plain, (out, grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


CHANNELS = {"obar": (1, 0), "gbar": (0, 1), "both": (1, 1)}


@pytest.mark.parametrize("n", [13, 21])
@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_outgrad_vjp_matches_pallas(nets, channel, n):
    """x_bar (channel A alone: grad's x-dependence is severed) and every
    W/b bar of the SDF net for each cotangent alone and both together."""
    jp, tp = nets
    x, _ = rows(n, seed=70 + n)
    rng = np.random.default_rng(71)
    cots = [rng.normal(size=(n, w)).astype(np.float32) * m
            for w, m in zip((SDF.d_out, 4), CHANNELS[channel])]
    ops = get_fused_ops(SDF, tile=8, interpret=True)
    _, vjp = jax.vjp(ops.outgrad, jp["sdf"], jnp.asarray(x))
    ref_p, ref_x = vjp(tuple(map(jnp.asarray, cots)))

    net = tp["sdf"]
    for p in net.parameters():
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TF.sdf_output_and_gradient(net, xt)
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cots])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), rtol=0,
                               atol=ATOL, err_msg="x_bar")
    assert_tree_close(grads_as_jax(net), ref_p, f"{channel} sdf")


def _random_bars(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(o, i, generator=g), torch.randn(o, generator=g))
            for o, i in pack._layer_shapes(cfg)]


@pytest.mark.parametrize("width", ["small", "full"])
def test_outgrad_grad_layout_round_trip(width):
    """pack then unpack of the K4-bwd gradient buffer is the identity; the
    ``gw_last0`` slot adds to row 0 of the last layer alone."""
    scfg = (TF.SDFConfig() if width == "full"
            else TF.SDFConfig(**dataclasses.asdict(SDF)))
    bars = _random_bars(scfg, 3)
    offs, size = pack.outgrad_grad_layout(scfg)
    buf = pack.pack_outgrad_grads(bars, scfg)
    assert buf.numel() == size
    for (gw, gb), (w, b) in zip(pack.unpack_outgrad_grads(buf, offs, scfg),
                                bars):
        torch.testing.assert_close(gw, w, rtol=0, atol=0)
        torch.testing.assert_close(gb, b, rtol=0, atol=0)
    extra = torch.arange(scfg.d_hidden, dtype=torch.float32)
    buf[offs["gw_last0"]:offs["gw_last0"] + scfg.d_hidden] = extra
    got = pack.unpack_outgrad_grads(buf, offs, scfg)
    torch.testing.assert_close(got[-1][0][0], bars[-1][0][0] + extra)
    torch.testing.assert_close(got[-1][0][1:], bars[-1][0][1:])
    # K1-bwd's buffer begins with the same SDF part.
    ccfg = TF.ColorConfig() if width == "full" else TF.ColorConfig(
        d_feature=32, d_hidden=64, n_layers=3, multires_view=2)
    rc_offs, _ = pack.rendercore_grad_layout(scfg, ccfg)
    for k in ("gw", "gb", "gw_last0"):
        assert rc_offs[k] == offs[k], k


def test_outgrad_pack_layout(nets):
    """K4's and K7's pack: b per hidden layer, W and W^T as the wgmma core's
    B (``wp``, ``wtp``), the head's column 0 and its feature columns both
    ways as wgmma B (``wfp``, ``wftp``; their layout is held against the
    core's descriptor in ``test_torch_wgmma_emulation.py``), and no plain
    matrix: every kernel of K4 and K7 reads the packed copies."""
    _, tp = nets
    P, offs = pack.pack_outgrad(tp["sdf"])
    assert not {"w", "wt", "w_feat", "w_feat_t"} & set(offs)
    with torch.no_grad():
        layers = pack.effective_layers(tp["sdf"])
        for l, (w, b) in enumerate(layers[:-1]):
            for name, bt in (("wp", w), ("wtp", w.t())):
                packed = pack.wg_pack_b(bt)
                torch.testing.assert_close(
                    P[offs[name][l]:offs[name][l] + packed.numel()], packed,
                    rtol=0, atol=0)
            torch.testing.assert_close(P[offs["b"][l]:offs["b"][l] + b.numel()],
                                       b, rtol=0, atol=0)
        w, b = layers[-1]
        feat = w[1:]
        for name, bt in (("wfp", feat), ("wftp", feat.t())):
            packed = pack.wg_pack_b(bt)
            torch.testing.assert_close(P[offs[name]:offs[name] + packed.numel()],
                                       packed, rtol=0, atol=0)
        torch.testing.assert_close(P[offs["w_last0"]:offs["w_last0"] + w.shape[1]],
                                   w[0], rtol=0, atol=0)
        torch.testing.assert_close(P[offs["b_feat"]:offs["b_feat"] + feat.shape[0]],
                                   b[1:], rtol=0, atol=0)


def test_outgrad_geometry_check():
    pack.check_outgrad_geometry(TF.SDFConfig())
    with pytest.raises(ValueError, match="d_out - 1"):
        pack.check_outgrad_geometry(TF.SDFConfig(d_out=31))


def test_outgrad_cuda_entries_refuse_cpu_tensors(nets):
    """The K4 launchers never compute on a CPU tensor: they raise."""
    _, tp = nets
    x = torch.from_numpy(rows(8, seed=80)[0])
    cfg = tp["sdf"].cfg
    with torch.no_grad():
        packed = pack.pack_outgrad(tp["sdf"])
        with pytest.raises(ValueError, match="CUDA tensor"):
            OG.sdf_outgrad_cuda(tp["sdf"], x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        OG.outgrad_bwd_cuda(cfg, packed, x, torch.zeros(8, cfg.d_out),
                            torch.zeros(8, 4))


class _Seen(Exception):
    """Raised by a spied forward launcher once it has recorded its pack."""


# Per cached pack: its nets (0 the SDF net, 1 the color net), the no-grad
# entry, the autograd.Function, the modules whose forward launcher both
# call, that launcher's name, the pack's place among its arguments, and the
# pack built from scratch out of each net's effective layers.
CACHED_PACKS = {
    "sdf_value": (pack.pack_sdf_value, (0,), SV.sdf_value_cuda, SVD.SdfValueDiff,
                  (SV, SVD), "launch_value", 1, pack.pack_sdf_value_layers),
    "outgrad": (pack.pack_outgrad, (0,), OG.sdf_outgrad_cuda, OG.SdfOutGrad, (OG,),
                "launch_outgrad_fwd", 1, pack.pack_outgrad_layers),
    "color": (pack.pack_color, (1,), CK.color_fwd_cuda, CK.ColorMLP, (CK,),
              "launch_color_fwd", 1, lambda c: pack.pack_color_layers(c, CK_CFG)),
    "rendercore": (pack.pack_rendercore, (0, 1), RC.rendercore_fwd_cuda, RC.RenderCore,
                   (RC,), "launch_fwd", 2,
                   lambda s, c: pack.pack_rendercore_layers(s, c, CK_CFG)),
}
CK_CFG = emulate.nets("small")[1].cfg


@pytest.mark.parametrize("kind", sorted(CACHED_PACKS))
def test_cached_pack_is_the_one_every_path_reads(kind, monkeypatch):
    """The pack cached on its net is the same object while the weights are
    unchanged, and a new one, bitwise the pack built from scratch, after an
    Adam step updates them in place. The autograd.Function gets the very
    object the no-grad launch reads (both call one forward launcher, spied
    here, on CPU rows past the emulation's input check), before the step
    and after it, when the Function's call misses and packs the effective
    layers it computed for its weight inputs."""
    cached, which, no_grad, function, modules, launcher, at, build_pack = \
        CACHED_PACKS[kind]
    nets = tuple(emulate.nets("small")[i] for i in which)
    g = torch.Generator().manual_seed(3)
    x, d, grad = (torch.randn((8, w), generator=g) for w in (4, 3, 4))
    rows = {"sdf_value": (x,), "outgrad": (x,), "rendercore": (x, d),
            "color": (x, d, grad, torch.randn((8, CK_CFG.d_feature), generator=g))}[kind]
    seen = []

    def spy(*args):
        seen.append(args[at])
        raise _Seen

    for module in modules:
        monkeypatch.setattr(module, launcher, spy)
    monkeypatch.setattr(build, "check_input", emulate._check_host_input)

    def both_paths():
        seen.clear()
        with pytest.raises(_Seen):
            pack.apply_with_cached_pack(function, nets, cached, *rows)
        with torch.no_grad(), pytest.raises(_Seen):
            no_grad(*nets, *rows)
        return seen

    first = cached(*nets)
    assert cached(*nets) is first
    assert [p is first for p in both_paths()] == [True, True]
    params = [p for net in nets for p in net.parameters()]
    opt = torch.optim.Adam(params, lr=1e-2)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    after = both_paths()
    assert after[0] is after[1] is cached(*nets) and after[0] is not first
    with torch.no_grad():
        fresh = build_pack(*(pack.effective_layers(net) for net in nets))
    assert torch.equal(after[0][0], fresh[0]) and not torch.equal(first[0], fresh[0])
    assert after[0][1] == fresh[1]
