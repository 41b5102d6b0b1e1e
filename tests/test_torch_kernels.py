"""Port parity for the two kernel modules of the render slice.

On the CPU each wrapper takes its kernel's plain PyTorch version; these are
held against the JAX package's Pallas kernels run in interpret mode (as the
JAX tests run them). The host-side weight packing the CUDA kernels read is
checked by an emulation that computes from the packed buffer with the
kernels' own layout. The CUDA kernels themselves are held against the plain
versions on the card by ``test_torch_gpu.py``.
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
from copenerf_torch.ops.kernels import sdf_value as SV

SDF = JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                   multires=3, bias=0.5, scale=1.3)
COLOR = JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                       multires_view=2)
ATOL = 2e-5


@pytest.fixture(scope="module")
def nets():
    """The JAX init, perturbed (``perturb_``): under the plain geometric init
    the PE columns are zero and the head's columns almost equal, so no check
    could see the PE, its sin/cos order or the feature column order."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp = {"sdf": JF.sdf_init(k1, SDF), "color": JF.color_init(k2, COLOR)}
    cfgs = {"sdf": TF.SDFConfig(**dataclasses.asdict(SDF)),
            "color": TF.ColorConfig(**dataclasses.asdict(COLOR))}
    tp = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfgs,
                           device="cpu")
    perturb_(tp, torch.Generator().manual_seed(0))
    return X.params_to_jax(tp), tp


def rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32) * 0.6
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("n", [13, 40])
def test_sdf_value_plain_vs_pallas(nets, n):
    jp, tp = nets
    x, _ = rows(n, seed=n)
    ref = get_fused_ops(SDF, tile=8, interpret=True).value(jp["sdf"],
                                                           jnp.asarray(x))
    got = SV.sdf_value(tp["sdf"], torch.from_numpy(x))
    assert got.shape == (n,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [13, 21])
def test_rendercore_fwd_plain_vs_pallas(nets, n):
    jp, tp = nets
    x, d = rows(n, seed=100 + n)
    fn = get_fused_rendercore(SDF, COLOR, tile_fwd=8, tile_bwd=8,
                              interpret=True)
    ref = fn(jp["sdf"], jp["color"], jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        got = RC.rendercore_fwd(tp["sdf"], tp["color"], torch.from_numpy(x),
                                torch.from_numpy(d))
    for g, r, name in zip(got, ref, ("sdf", "grad", "color")):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# The packed layout the CUDA kernels read, emulated in PyTorch
# ---------------------------------------------------------------------------

def _take(P, off, shape):
    n = int(np.prod(shape))
    return P[off:off + n].reshape(shape)


def _pe(v, m):
    parts = [v]
    for k in range(m):
        parts += [torch.sin(v * 2.0 ** k), torch.cos(v * 2.0 ** k)]
    return torch.cat(parts, -1)


def _wg(P, off, shape):
    """The matrix B (K, N) a wgmma pack holds at ``off``: its hi + lo parts,
    within 2^-21 of each value."""
    hi, lo = pack.wg_unpack_b(P[off:], *shape)
    return hi + lo


def _hidden_w(P, offs, l, d_in, d_out):
    """SDF hidden layer l's W (in, out), as wgmma B in every pack."""
    return _wg(P, offs["wp"][l], (d_in, d_out))


def _emulate_sdf(P, offs, cfg, x, keep=None):
    c = 1.0 / np.sqrt(2.0)
    n_lin = len(cfg.dims) - 1
    skip = pack.sdf_skip(cfg)
    e = _pe(x * cfg.scale, cfg.multires)
    h = e
    for l in range(n_lin - 1):
        d_in, d_out = TF.idr_layer_dims(cfg, l)
        if l == skip:
            h = torch.cat([h, e * c], -1)
        z = h @ _hidden_w(P, offs, l, d_in, d_out) + _take(
            P, offs["b"][l], (d_out,))
        h = torch.nn.functional.softplus(z, beta=100.0, threshold=20.0)
        if keep is not None:
            keep.append(torch.sigmoid(100.0 * z))
        if l + 1 == skip:
            h = h * c
    w0 = _take(P, offs["w_last0"], (cfg.d_hidden,))
    sdf = (h @ w0 + P[offs["b_last0"]]) / cfg.scale
    return sdf, h, e


def test_packed_layout_value(nets):
    _, tp = nets
    x, _ = rows(17, seed=3)
    with torch.no_grad():
        P, offs = pack.pack_sdf_value(tp["sdf"])
        sdf, _, _ = _emulate_sdf(P, offs, tp["sdf"].cfg, torch.from_numpy(x))
        ref = SV.sdf_value_plain(tp["sdf"], torch.from_numpy(x))
    flat = [o for v in offs.values() for o in (v if isinstance(v, list)
                                               else [v])]
    assert all(o % 4 == 0 for o in flat)
    assert len(offs["wp"]) == len(offs["wtp"]) == len(offs["b"]) == len(tp["sdf"].cfg.dims) - 2
    assert not {"w", "wt", "wfp", "wftp", "b_feat"} & set(offs)
    np.testing.assert_allclose(sdf.numpy(), ref.numpy(), rtol=0, atol=ATOL)


def test_packed_layout_rendercore(nets):
    """The kernel's algorithm on the packed buffer (every hidden matrix and
    the feature columns as wgmma B, read back as hi + lo): forward, the
    reverse input-gradient sweep over W^T, J_pe^T, and the color MLP on the
    permuted [feature, x, PE(dirs), grad, 0] input."""
    _, tp = nets
    scfg, ccfg = tp["sdf"].cfg, tp["color"].cfg
    xn, dn = rows(19, seed=4)
    x, d = torch.from_numpy(xn), torch.from_numpy(dn)
    c = 1.0 / np.sqrt(2.0)
    with torch.no_grad():
        P, offs = pack.pack_rendercore(tp["sdf"], tp["color"])
        sigs = []
        sdf, h, e = _emulate_sdf(P, offs, scfg, x, keep=sigs)
        d_feat = ccfg.d_feature
        feat = h @ _wg(P, offs["wfp"], (scfg.d_hidden, d_feat)) + \
            _take(P, offs["b_feat"], (d_feat,))
        n_lin, skip = len(scfg.dims) - 1, pack.sdf_skip(scfg)
        d0 = scfg.dims[0]
        q = _take(P, offs["w_last0"], (scfg.d_hidden,)) * sigs[-1]
        ee_skip = 0.0
        for l in range(n_lin - 2, -1, -1):
            d_in, d_out = TF.idr_layer_dims(scfg, l)
            p = q @ _wg(P, offs["wtp"][l], (d_out, d_in))
            if l == skip:
                p = p * c
                ee_skip = p[:, d_in - d0:]
                p = p[:, :d_in - d0]
            q = p * sigs[l - 1] if l > 0 else p + ee_skip
        xs = x * scfg.scale
        grad = q[:, :4].clone()
        for k in range(scfg.multires):
            f = 2.0 ** k
            cs = 4 + 8 * k
            grad += (q[:, cs:cs + 4] * torch.cos(xs * f) * f
                     - q[:, cs + 4:cs + 8] * torch.sin(xs * f) * f)
        k0 = pack.color_k0(ccfg)
        hin = torch.cat([feat, x, _pe(d, ccfg.multires_view), grad], -1)
        hin = torch.cat([hin, hin.new_zeros((hin.shape[0],
                                             k0 - hin.shape[1]))], -1)
        dims = list(ccfg.dims)
        dims[0] = k0
        for l in range(len(dims) - 1):
            w = (_wg(P, offs["wcp"][l], (dims[l], dims[l + 1])) if l < len(dims) - 2
                 else _take(P, offs["wc_last"], (dims[l], dims[l + 1])))
            hin = hin @ w + _take(P, offs["bc"][l], (dims[l + 1],))
            if l < len(dims) - 2:
                hin = torch.relu(hin)
        color = torch.sigmoid(hin)
        ref = RC.rendercore_fwd_plain(tp["sdf"], tp["color"], x, d)
    for g, r, name in zip((sdf[:, None], grad, color), ref,
                          ("sdf", "grad", "color")):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_pack_cache_follows_parameter_versions(nets):
    """A pack is reused while the weights are unchanged and rebuilt after an
    in-place update."""
    _, tp = nets
    sdf_net = TF.SDFNetwork(tp["sdf"].cfg)
    sdf_net.load_state_dict(tp["sdf"].state_dict())
    color_net = TF.ColorNetwork(tp["color"].cfg)
    color_net.load_state_dict(tp["color"].state_dict())
    p1, _ = pack.pack_sdf_value(sdf_net)
    r1, _ = pack.pack_rendercore(sdf_net, color_net)
    assert pack.pack_sdf_value(sdf_net)[0] is p1
    assert pack.pack_rendercore(sdf_net, color_net)[0] is r1
    with torch.no_grad():
        color_net.layers["lin0"].b += 1.0
    assert pack.pack_sdf_value(sdf_net)[0] is p1
    r2, offs = pack.pack_rendercore(sdf_net, color_net)
    assert r2 is not r1
    n_b = color_net.layers["lin0"].b.numel()
    torch.testing.assert_close(r2[offs["bc"][0]:offs["bc"][0] + n_b],
                               r1[offs["bc"][0]:offs["bc"][0] + n_b] + 1.0)
    with torch.no_grad():
        sdf_net.layers["lin0"].v.mul_(2.0)     # same W: weight norm
    assert pack.pack_sdf_value(sdf_net)[0] is not p1


def test_checks_see_the_pe_and_column_order(nets, monkeypatch):
    """On the checks' weights, a PE with sin and cos swapped, or the feature
    columns in another order, moves the outputs far past the tolerance, so a
    kernel with either fault fails its check."""
    from copenerf_torch.models import embedder

    _, tp = nets
    xn, dn = rows(64, seed=6)
    x, d = torch.from_numpy(xn), torch.from_numpy(dn)
    with torch.no_grad():
        ref = RC.rendercore_fwd_plain(tp["sdf"], tp["color"], x, d)

    def swapped(v, m):
        parts = [v]
        for k in range(m):
            parts += [torch.cos(v * 2.0 ** k), torch.sin(v * 2.0 ** k)]
        return torch.cat(parts, -1)

    monkeypatch.setattr(TF, "positional_encoding", swapped)
    with torch.no_grad():
        bad = RC.rendercore_fwd_plain(tp["sdf"], tp["color"], x, d)
    for name, g, r in zip(("sdf", "grad", "color"), bad, ref):
        assert (g - r).abs().max().item() > 100 * ATOL, name
    monkeypatch.setattr(TF, "positional_encoding", embedder.positional_encoding)
    with torch.no_grad():
        out = tp["sdf"](x)
        feat = out[:, 1:]
        _, grad, _ = ref
        c1 = TF.color_apply(tp["color"], x, grad, d, feat)
        c2 = TF.color_apply(tp["color"], x, grad, d, feat.flip(-1))
    assert (c1 - c2).abs().max().item() > 10 * ATOL


def test_color_input_permutation_is_a_permutation():
    ccfg = TF.ColorConfig()
    perm = pack.color_input_permutation(ccfg)
    assert sorted(perm) == list(range(ccfg.dims[0]))
    assert perm[:256] == list(range(35, 291)) and perm[256:260] == [0, 1, 2, 3]
    assert pack.color_k0(ccfg) == 292


def test_geometry_checks():
    pack.check_sdf_geometry(TF.SDFConfig())
    pack.check_color_geometry(TF.SDFConfig(), TF.ColorConfig())
    with pytest.raises(ValueError):
        pack.check_sdf_geometry(TF.SDFConfig(d_hidden=512))
    with pytest.raises(ValueError):
        pack.check_color_geometry(TF.SDFConfig(),
                                  TF.ColorConfig(mode="no_normal"))


def test_cuda_entry_refuses_cpu_tensors(nets):
    """The CUDA launchers never compute on a CPU tensor: they raise."""
    _, tp = nets
    x, d = rows(8, seed=5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SV.sdf_value_cuda(tp["sdf"], torch.from_numpy(x))
    with pytest.raises(ValueError, match="CUDA tensor"):
        RC.rendercore_fwd_cuda(tp["sdf"], tp["color"], torch.from_numpy(x),
                               torch.from_numpy(d))


def test_unported_color_mode_raises_off_cpu(nets):
    """Off the CPU, a color mode whose TPU path is the outgrad kernel (K4)
    reaches that kernel's launcher, which refuses a tensor that is not on a
    CUDA card, instead of running the plain version."""
    _, tp = nets
    ccfg = dataclasses.replace(tp["color"].cfg, mode="no_normal", d_in=7,
                               multires_view=0)
    color = TF.ColorNetwork(ccfg)
    x = torch.empty((8, 4), device="meta")
    d = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        TF.sdf_grad_color(tp["sdf"], color, x, d)
