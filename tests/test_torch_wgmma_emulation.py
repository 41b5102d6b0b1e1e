"""The wgmma core of every row kernel (``csrc/wgmma_tile.cuh``) and the
weight-gradient reduction (``csrc/wgrad.cu``) as the host emulation runs
them (``copenerf_torch/ops/kernels/emulate.py``: ``wgmma.mma_async``
m64n128k8 TF32 with A from registers and B through a shared-memory
descriptor, ``mbarrier``, ``cp.async.bulk``), on CPU tensors:

* the host packing of B (``pack.wg_pack_b``) read back through the
  descriptor's address arithmetic (the 128-byte swizzle, 1024-byte row
  groups, the k permutation), for B and for B^T, ragged K and N, split into
  hi and lo, and the SDF head's feature columns as the outgrad pack holds
  them (``wfp``, ``wftp``): every element lands where the core reads it,
  and the padding is zero;
* small integers, exact in TF32 and in every partial sum, through the tile
  GEMM of ``csrc/tc_check.cu`` in every wgmma mode at ragged K and N < 256:
  the fragment layouts, the descriptor strides and the swizzle must give the
  product exactly;
* the one-stage ring of K1-bwd, K4-bwd, K5-bwd and K6-bwd over 2, 5 and 8
  slices (every refill waits on the next phase of the one barrier): the
  two-stage ring's product bit for bit;
* one TF32 product against numpy's f64 product of the operands rounded to
  TF32: within 4e-7 relative (the f32 sums);
* 3xTF32 through either ring against f64: within 2x the f32 FFMA GEMM's
  error and within 1e-6 relative, at the widths the kernels multiply (K =
  52, 204, 256, 292) and ragged ones; one TF32 product is far from it;
* K2, K3-bwd, K4-fwd (out and grad), K4-bwd (per cotangent channel),
  K7-fwd and K7-bwd (per cotangent channel) through their own wrappers at
  a width whose layers, and the feature head, are wider than one
  warpgroup's 128 columns (the second warpgroup's ragged columns), and at
  one with a K tail in every GEMM, against their plain versions with
  ``chip_smoke.py``'s rules;
* the weight-gradient reduction every backward kernel runs (``wgmma`` with
  A = Z^T from registers and B = T transposed and split by the block's
  threads) at widths past one 128 x 128 tile: against f64 within 2x the
  FFMA reduction's error or 1e-6 (on one row and on a split with a ragged
  tail; staged padding NaN), and exact on small integers with a second
  pair that stops early and with ones for z;
* the color pack (``pack.pack_color_layers``: every hidden layer as wgmma B
  both ways, layer 0 in the kernel's input order, h0_bar's columns past 256
  apart) read back through the descriptor, and K5-fwd and K5-bwd through
  their own wrappers with hidden layers past one warpgroup (d_hidden 160),
  a K tail in every hidden GEMM (136), and a color input past 256 columns
  with a K tail (k0 = 268: layer 0's tail slice, h0_bar's second pass);
* the render-core pack (``pack.pack_rendercore_layers``) byte for byte the
  outgrad pack's SDF part and the color pack's color part, no plain copy;
  K1-fwd and K6-fwd through their own wrappers with every layer, the
  feature head and the color layers past one warpgroup and a 268-wide
  color input (d_hidden 160, d_feature 232), and with a K tail in every
  GEMM (136); K1-bwd and K6-bwd at d_hidden 160 per cotangent channel
  (sbar, gbar, cbar, K6's swbar, all) with ``chip_smoke.py``'s rules
  (``KINK_MARGIN`` on the color cotangent); K1-bwd for frozen fields per
  channel: None for every weight and bias, x_bar and dirs_bar the full
  kernel's bit for bit and within the same rule; with one color layer
  trainable, the full kernel and that layer's W and b bars.

Skips where there is no ``g++``."""

import copy
import functools
import shutil

import numpy as np
import pytest
import torch

from copenerf_torch.models import fields as F
from copenerf_torch.models.mlp import perturb_
from copenerf_torch.ops.kernels import color as CK
from copenerf_torch.ops.kernels import emulate, pack
from copenerf_torch.ops.kernels import outgrad as OG
from copenerf_torch.ops.kernels import rendercore as RC
from copenerf_torch.ops.kernels import rendercore_cons as RCC
from copenerf_torch.ops.kernels import sdf_out as SO
from copenerf_torch.ops.kernels import sdf_value as SV
from copenerf_torch.ops.kernels import sdf_value_diff as SVD
from copenerf_torch.ops.kernels import tc_check as TC


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the CUDA kernels needs g++")
    with emulate.emulated():
        yield


def tf32_np(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32)
    finite = (bits & 0x7F800000) != 0x7F800000
    bits = np.where(finite, (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000), bits)
    return bits.astype(np.uint32).view(np.float32)


def _read_packed(packed: np.ndarray, K: int, N: int) -> np.ndarray:
    """The hi and lo parts of B (K x N) as the core reads the packed
    buffer: slice s, k8 step j, element (k, n) at byte 32 j + 4 k of its
    128-byte row n, rows 1024 bytes a group of 8, the 16-byte chunk XOR
    (row % 8), A's k order within each 16-column block undone."""
    n_pad, k_pad = -(-N // 128) * 128, -(-K // 32) * 32
    raw = packed.view(np.uint8)
    out = np.zeros((2, k_pad, n_pad), np.float32)
    for s in range(k_pad // 32):
        for part in range(2):
            base = (2 * s + part) * n_pad * 128
            for j in range(4):
                for kk in range(8):
                    b, h = j // 2, j % 2
                    k_in = 16 * b + 4 * (kk % 4) + 2 * h + kk // 4
                    for n in range(n_pad):
                        a = (n // 8) * 1024 + (n % 8) * 128 + 32 * j + 4 * kk
                        a ^= ((a >> 7) & 7) << 4
                        out[part, 32 * s + k_in, n] = raw[base + a:base + a + 4].view(
                            np.float32)[0]
    return out


def _feature_pack(name: str, hidden: int, d_feat: int):
    """(B (K, N), its pack) for the outgrad pack's ``name`` of a perturbed
    net: ``wfp`` is the forward head's B = W_feat (hidden, d_feat), ``wftp``
    the backward's B = W_feat^T (d_feat, hidden)."""
    cfg = F.SDFConfig(d_out=d_feat + 1, d_hidden=hidden, n_layers=3, skip_in=(),
                      multires=2)
    net = perturb_(F.SDFNetwork(cfg, torch.Generator().manual_seed(hidden)),
                   torch.Generator().manual_seed(d_feat))
    layers = pack.effective_layers(net)
    params, offs = pack.pack_outgrad_layers(layers)
    w_feat = layers[-1][0][1:].detach()              # (d_feat, hidden)
    b = w_feat.t() if name == "wfp" else w_feat
    K, N = b.shape
    size = 2 * -(-N // 128) * 128 * -(-K // 32) * 32
    return b.numpy(), params[offs[name]:offs[name] + size].numpy()


@pytest.mark.parametrize("K,N,transposed", [(52, 204, False), (36, 136, True),
                                            (64, 28, True), (256, 52, False),
                                            (204, 256, True), (292, 256, False),
                                            (4, 4, True), (32, 128, False),
                                            (160, 160, "wfp"), (160, 160, "wftp"),
                                            (256, 36, "wfp"), (36, 256, "wftp")])
def test_wg_pack_b_layout_matches_the_descriptor(K, N, transposed):
    """``transposed`` a name: the feature pack ``wfp`` (K = hidden, N =
    d_feat) or ``wftp`` (K = d_feat, N = hidden) of ``pack_outgrad_layers``."""
    if isinstance(transposed, str):
        hidden, d_feat = (K, N) if transposed == "wfp" else (N, K)
        b, packed = _feature_pack(transposed, hidden, d_feat)
        assert b.shape == (K, N)
    else:
        rng = np.random.default_rng(K * N)
        m = rng.standard_normal((N, K) if transposed else (K, N)).astype(np.float32)
        b = m.T if transposed else m                   # B (K, N)
        bt = torch.from_numpy(m) if transposed else torch.from_numpy(m).t()
        packed = pack.wg_pack_b(bt).numpy()
    got = _read_packed(packed, K, N)
    hi, lo = got[:, :K, :N]
    np.testing.assert_array_equal(hi, tf32_np(b))
    np.testing.assert_array_equal(lo, tf32_np(b - tf32_np(b)))
    np.testing.assert_allclose(hi.astype(np.float64) + lo, b, rtol=2 ** -21, atol=0)
    pad = got.copy()
    pad[:, :K, :N] = 0
    assert not pad.any()


@pytest.mark.parametrize("K,N", [(52, 256), (204, 256), (28, 64), (256, 204),
                                 (64, 136), (292, 36)])
def test_emulated_wgmma_is_exact_on_integers(emu, K, N):
    rng = np.random.default_rng(K + N)
    a = rng.integers(-8, 9, size=(70, K)).astype(np.float32)
    w = rng.integers(-8, 9, size=(K, N)).astype(np.float32)
    for mode in TC.WG_MODES:
        got = TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w), mode).numpy()
        np.testing.assert_array_equal(got, a.astype(np.float64) @ w, err_msg=mode)


@pytest.mark.parametrize("K", [52, 160, 256])
def test_emulated_one_stage_ring_matches_two_stages(emu, K):
    """K4-bwd's one-stage ring over K = 52, 160 and 256 (2, 5 and 8 slices
    through one stage and one barrier, whose parity alternates): the same
    products in the same order as the two-stage ring, so the same bits, and
    exact on small integers."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((130, K)).astype(np.float32)
    w = (rng.standard_normal((K, 256)) / np.sqrt(K)).astype(np.float32)
    one, two = (TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w), m).numpy()
                for m in ("wg_1stage", "wg"))
    np.testing.assert_array_equal(one, two)
    ai = rng.integers(-8, 9, size=(70, K)).astype(np.float32)
    wi = rng.integers(-8, 9, size=(K, 160)).astype(np.float32)
    got = TC.tile_gemm(torch.from_numpy(ai), torch.from_numpy(wi), "wg_1stage").numpy()
    np.testing.assert_array_equal(got, ai.astype(np.float64) @ wi)


def _mats(m, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return a, w


@pytest.mark.parametrize("K,N", [(52, 256), (204, 36), (256, 52)])
def test_emulated_wgmma_tf32_product_matches_numpy(emu, K, N):
    a, w = _mats(70, K, N, seed=K * 7 + N)
    got = TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w), "wg_tf32").numpy()
    ref = tf32_np(a).astype(np.float64) @ tf32_np(w).astype(np.float64)
    assert np.linalg.norm(got - ref) <= 4e-7 * np.linalg.norm(ref)


@pytest.mark.parametrize("ring", ["wg", "wg_1stage"])
@pytest.mark.parametrize("K,N", [(52, 256), (204, 256), (256, 204), (256, 52),
                                 (28, 64), (292, 36)])
def test_emulated_wgmma_3xtf32_against_f64(emu, K, N, ring):
    """Either ring: two stages (K1-fwd, K6-fwd, K2, K3, K4-fwd, K5-fwd, K7)
    and one (K1-bwd, K6-bwd, K4-bwd, K5-bwd), at the widths the kernels multiply and ragged ones
    (K = 292: the render core's color input)."""
    a, w = _mats(130, K, N, seed=3 * K + N)
    a = np.abs(a)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    err = {m: np.linalg.norm(TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w),
                                          m).numpy() - ref) / np.linalg.norm(ref)
           for m in ("ffma", ring, "wg_tf32")}
    assert err[ring] <= min(2 * err["ffma"], 1e-6), err
    assert err["wg_tf32"] > 1e-5, err                # the split is what buys it


WIDE = F.SDFConfig(d_out=9, d_hidden=160, n_layers=4, skip_in=(2,), multires=3,
                   scale=1.3)
# K4's and K7's nets: the feature head (d_feat = 160) past one warpgroup too;
# at d_hidden 136 every GEMM, the head's both ways included, has a K tail.
HEADS = {160: F.SDFConfig(d_out=161, d_hidden=160, n_layers=4, skip_in=(2,), multires=3,
                          scale=1.3),
         136: F.SDFConfig(d_out=137, d_hidden=136, n_layers=4, skip_in=(2,), multires=3,
                          scale=1.3)}
_HEAD_NETS = {}


def head_net(hidden):
    if hidden not in _HEAD_NETS:
        _HEAD_NETS[hidden] = perturb_(
            F.SDFNetwork(HEADS[hidden], torch.Generator().manual_seed(hidden)),
            torch.Generator().manual_seed(4))
    return _HEAD_NETS[hidden]


@pytest.fixture(scope="module")
def wide_net():
    return perturb_(F.SDFNetwork(WIDE, torch.Generator().manual_seed(0)),
                    torch.Generator().manual_seed(2))



def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1.2, 1.2, size=(n, 4)).astype(np.float32))


def test_emulated_k2_past_one_warpgroup(emu, wide_net):
    x = _rows(100, 5)
    with torch.no_grad():
        got = SV.launch_value(WIDE, pack.pack_sdf_value(wide_net), x, SV.COUNTER)
        ref = SV.sdf_value_plain(wide_net, x)
    assert (got - ref).abs().max().item() <= 1e-4


def test_emulated_k3_bwd_past_one_warpgroup(emu, wide_net):
    """Every gradient of K3 (the wgmma forward and down-sweep, the
    tensor-core reduction) within 2x the plain f32 version's error against
    f64, or 1e-5 (``chip_smoke.py``'s rule)."""
    x = _rows(100, 6)
    obar = torch.from_numpy(np.random.default_rng(7).standard_normal(100).astype(np.float32))
    net64 = copy.deepcopy(wide_net).double()
    ws, bs = zip(*pack.effective_layers(wide_net))

    def grads(fn, net, xx, cot):
        xx = xx.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xx), [xx, *net.parameters()], cot)

    got = grads(lambda xx: SVD.SdfValueDiff.apply(WIDE, pack.pack_sdf_value(wide_net), xx,
                                                  *ws, *bs), wide_net, x, obar)
    plain = grads(lambda xx: SVD.sdf_value_diff_plain(wide_net, xx), wide_net, x, obar)
    r64 = grads(lambda xx: SVD.sdf_value_diff_plain(net64, xx), net64, x.double(),
                obar.double())
    _within_plain(got, plain, r64)


def _within_plain(got, plain, r64):
    """Each gradient tensor within 2x the plain f32 version's error against
    f64, or 1e-5 of its norm."""
    for a, b, c in zip(got, plain, r64):
        dk, dp = (a.double() - c).norm().item(), (b.double() - c).norm().item()
        assert dk <= max(2 * dp, 1e-5 * c.norm().item()), (dk, dp)


@pytest.mark.parametrize("hidden", [160, 136])
def test_emulated_k4_fwd_and_k7_fwd_past_one_warpgroup(emu, hidden):
    """K4-fwd's head and gradient and K7-fwd's head (the hidden layers, the
    feature columns and the sweep on the wgmma core) against their plain
    versions: 1e-4, the gradient 1e-4 of its largest entry."""
    cfg, net = HEADS[hidden], head_net(hidden)
    x = _rows(70, 8)
    packed = pack.pack_outgrad(net)
    with torch.no_grad():
        out, grad = OG.launch_outgrad_fwd(cfg, packed, x)
        ref_out, ref_grad = OG.sdf_outgrad_plain(net, x)
        head = SO.launch_out_fwd(cfg, packed, x)
    assert (out - ref_out).abs().max().item() <= 1e-4
    assert (head - ref_out).abs().max().item() <= 1e-4
    lim = 1e-4 * max(1.0, ref_grad.abs().max().item())
    assert (grad - ref_grad).abs().max().item() <= lim


@pytest.mark.parametrize("hidden,chan", [(160, "obar"), (160, "gbar"), (160, "both"),
                                         (136, "both")])
def test_emulated_k4_bwd_past_one_warpgroup(emu, hidden, chan):
    """K4-bwd (every sweep on the one-stage wgmma ring, the tensor-core
    reduction) per cotangent channel: x_bar and every weight gradient
    within 2x the plain f32 version's error against f64, or 1e-5."""
    cfg, net = HEADS[hidden], head_net(hidden)
    x = _rows(70, 9)
    rng = np.random.default_rng(10)
    mo, mg = {"obar": (1, 0), "gbar": (0, 1), "both": (1, 1)}[chan]
    obar = torch.from_numpy(rng.standard_normal((70, cfg.d_out)).astype(np.float32)) * mo
    gbar = torch.from_numpy(rng.standard_normal((70, 4)).astype(np.float32)) * mg
    net64 = copy.deepcopy(net).double()
    ws, bs = zip(*pack.effective_layers(net))

    def grads(fn, m, xx, cots):
        xx = xx.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xx), [xx, *m.parameters()], cots, allow_unused=True)

    got = grads(lambda xx: OG.SdfOutGrad.apply(cfg, pack.pack_outgrad(net), xx, *ws, *bs),
                net, x, [obar, gbar])
    plain = grads(lambda xx: OG.sdf_outgrad_plain(net, xx), net, x, [obar, gbar])
    r64 = grads(lambda xx: OG.sdf_outgrad_plain(net64, xx), net64, x.double(),
                [obar.double(), gbar.double()])
    _within_plain(*([torch.zeros_like(t) if t is None else t for t in g]
                    for g in (got, plain, r64)))


@pytest.mark.parametrize("hidden,chan", [(160, "sbar"), (160, "feat"), (160, "all"),
                                         (136, "all")])
def test_emulated_k7_bwd_past_one_warpgroup(emu, hidden, chan):
    """K7-bwd (the forward, the feature product over ``wftp`` and the
    down-sweep on the two-stage wgmma ring, the wgmma reduction with the
    head's 161 or 137 rows) per cotangent channel: the head's column 0, its
    feature columns, all; x_bar and every weight gradient within 2x the
    plain f32 version's error against f64, or 1e-5."""
    cfg, net = HEADS[hidden], head_net(hidden)
    x = _rows(70, 14)
    obar = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (70, cfg.d_out)).astype(np.float32))
    mask = torch.zeros(cfg.d_out)
    mask[{"sbar": slice(0, 1), "feat": slice(1, None), "all": slice(None)}[chan]] = 1
    obar = obar * mask
    net64 = copy.deepcopy(net).double()
    ws, bs = zip(*pack.effective_layers(net))

    def grads(fn, m, xx, cot):
        xx = xx.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xx), [xx, *m.parameters()], cot)

    got = grads(lambda xx: SO.SdfOut.apply(cfg, pack.pack_outgrad(net), xx, *ws, *bs),
                net, x, obar)
    plain = grads(lambda xx: SO.sdf_out_plain(net, xx), net, x, obar)
    r64 = grads(lambda xx: SO.sdf_out_plain(net64, xx), net64, x.double(), obar.double())
    _within_plain(got, plain, r64)


# The reduction's widths past one 128 x 128 tile, with ragged edges: K7's
# head (O = 257) over layer 0's input (I = 52), a hidden layer of 160 over
# K1's color input (I = 292), K5's head (O = 3, one warpgroup idle).
REDUCE_SHAPES = [(257, 52), (160, 292), (3, 268)]


def _staged(rng, n, width, nonneg=False, integers=False):
    """(n, width rounded up to 4) f32 rows as the backward kernels stage
    them: the columns past width hold NaN, which no sum may read."""
    out = np.full((n, -(-width // 4) * 4), np.nan, np.float32)
    if integers:
        out[:, :width] = rng.integers(-8, 9, size=(n, width))
    else:
        v = rng.standard_normal((n, width))
        out[:, :width] = np.abs(v) if nonneg else v
    return out


@pytest.mark.parametrize("n", [1, 1100])
@pytest.mark.parametrize("O,I", REDUCE_SHAPES)
def test_emulated_wg_reduction_against_f64(emu, O, I, n):
    """The wgmma reduction (3xTF32) against f64 at widths past one tile,
    on one row (each output one product) and on a split and a ragged tail
    (1100 = 1024 + 76 rows: two slices and 12 rows): within 2x the FFMA
    reduction's error, or 1e-6; the bias sums within 1e-4. One TF32 product
    is far from it."""
    rng = np.random.default_rng(O * I + n)
    z, t = _staged(rng, n, O), _staged(rng, n, I, nonneg=True)
    ref = z[:, :O].T.astype(np.float64) @ t[:, :I]
    err = {}
    for m in ("ffma", "wg", "wg_tf32"):
        w_out, b_out = TC.row_reduce(torch.from_numpy(z), torch.from_numpy(t), O, I, m)
        err[m] = np.linalg.norm(w_out.numpy() - ref) / np.linalg.norm(ref)
        np.testing.assert_allclose(b_out.numpy(), z[:, :O].sum(0), rtol=0, atol=1e-4)
    assert err["wg"] <= max(2 * err["ffma"], 1e-6), err
    assert err["wg_tf32"] > 1e-5, err                # the split is what buys it


@pytest.mark.parametrize("kind", ["one pair", "second pair stops early",
                                  "ones, stopping early"])
@pytest.mark.parametrize("O,I", REDUCE_SHAPES)
def test_emulated_wg_reduction_is_exact_on_integers(emu, O, I, kind):
    """Small integers on 1100 rows, exact in TF32 and in every sum, so the
    fragment layout, the B transpose and its swizzle, the tile edges, the
    row tails and the pairs' row limits must give the sums exactly: one
    pair; a second pair that stops at row 517 (the render-core backward's
    sweep rows; its rows past 517 hold values no sum may read); ones for z
    stopping at row 700 (the render core's row-0 job)."""
    rng = np.random.default_rng(O + I)
    n = 1100
    z, t = _staged(rng, n, O, integers=True), _staged(rng, n, I, integers=True)
    zt, tt = torch.from_numpy(z), torch.from_numpy(t)
    if kind == "one pair":
        got = TC.row_reduce(zt, tt, O, I)
        ref = z[:, :O].T.astype(np.float64) @ t[:, :I]
        ref_b = z[:, :O].sum(0)
    elif kind == "second pair stops early":
        z2, t2 = _staged(rng, n, O, integers=True), _staged(rng, n, I, integers=True)
        got = TC.row_reduce(zt, tt, O, I, pair2=(torch.from_numpy(z2), torch.from_numpy(t2),
                                                 517))
        ref = (z[:, :O].T.astype(np.float64) @ t[:, :I]
               + z2[:517, :O].T.astype(np.float64) @ t2[:517, :I])
        ref_b = z[:, :O].sum(0)
    else:
        got = TC.row_reduce(None, tt, O, I, rows=700)
        ref = np.repeat(t[:700, :I].astype(np.float64).sum(0)[None], O, 0)
        ref_b = np.full(O, 700.0)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    np.testing.assert_array_equal(got[1].numpy(), ref_b)


# K5's nets: hidden layers past one warpgroup; a K tail in every hidden GEMM;
# a color input of k0 = 268 (d_feature 232, multires_view 4): 8 slices and a
# tail of 12 in layer 0, h0_bar in passes of 256 and 12 columns.
COLOR_WIDE = {
    "hidden160": F.ColorConfig(d_feature=64, d_hidden=160, n_layers=3, multires_view=2),
    "hidden136": F.ColorConfig(d_feature=64, d_hidden=136, n_layers=3, multires_view=2),
    "k0_268": F.ColorConfig(d_feature=232, d_hidden=64, n_layers=2, multires_view=4),
}
_COLOR_NETS = {}
KINK_MARGIN = 2e-5   # chip_smoke.py's: no color cotangent within it of a ReLU kink


def color_net(name):
    if name not in _COLOR_NETS:
        cfg = COLOR_WIDE[name]
        _COLOR_NETS[name] = perturb_(
            F.ColorNetwork(cfg, torch.Generator().manual_seed(cfg.d_hidden)),
            torch.Generator().manual_seed(5))
    return _COLOR_NETS[name]


@pytest.mark.parametrize("name,key,layer", [
    ("k0_268", "wcp", 0), ("k0_268", "wctp", 0), ("k0_268", "wct0tp", 0),
    ("hidden160", "wcp", 0), ("hidden160", "wctp", 0), ("hidden160", "wcp", 1),
    ("hidden136", "wcp", 2), ("hidden136", "wctp", 2)])
def test_color_wg_pack_layout_matches_the_descriptor(name, key, layer):
    """``wcp[l]`` is B = W_l^T (in x out), ``wctp[l]`` B = W_l (out x in;
    layer 0: its first 256 input columns), ``wct0tp`` layer 0's columns
    256 .. k0; layer 0's inputs in the kernel's order, zero past k0."""
    cfg = COLOR_WIDE[name]
    layers = pack.effective_layers(color_net(name))
    params, offs = pack.pack_color_layers(layers, cfg)
    w = layers[layer][0].detach()
    if layer == 0:
        w = pack.color_kernel_inputs(w, cfg)               # (hidden, k0)
    b = {"wcp": w.t(), "wctp": w[:, :256], "wct0tp": w[:, 256:]}[key].numpy()
    K, N = b.shape
    off = offs[key] if key == "wct0tp" else offs[key][layer]
    size = 2 * -(-N // 128) * 128 * -(-K // 32) * 32
    got = _read_packed(params[off:off + size].numpy(), K, N)
    hi, lo = got[:, :K, :N]
    np.testing.assert_array_equal(hi, tf32_np(b))
    np.testing.assert_array_equal(lo, tf32_np(b - tf32_np(b)))
    pad = got.copy()
    pad[:, :K, :N] = 0
    assert not pad.any()


def test_color_pack_holds_what_the_kernels_read():
    """The hidden layers only as wgmma B (no plain copy), the head plain
    both ways, h0_bar's tail only where k0 > 256."""
    for name, cfg in COLOR_WIDE.items():
        layers = pack.effective_layers(color_net(name))
        _, offs = pack.pack_color_layers(layers, cfg)
        tail = {"wct0tp"} if pack.color_k0(cfg) > 256 else set()
        assert set(offs) == {"wcp", "wctp", "bc", "wc_last", "wct_last"} | tail, name
        assert len(offs["wcp"]) == len(offs["wctp"]) == len(layers) - 1
        assert len(offs["bc"]) == len(layers)


def _color_rows(cfg, n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    cols = [rng.uniform(-1.2, 1.2, size=(n, 4)), d / np.linalg.norm(d, axis=-1, keepdims=True),
            rng.normal(size=(n, 4)), 0.5 * rng.normal(size=(n, cfg.d_feature))]
    return [torch.from_numpy(c.astype(np.float32)) for c in cols]


@pytest.mark.parametrize("name", sorted(COLOR_WIDE))
def test_emulated_k5_fwd_past_one_warpgroup(emu, name):
    """K5-fwd (every hidden layer on the two-stage wgmma ring, over the
    color input it overwrites) against its plain version: 1e-4; the feature
    a column slice of a wider head, as K4's."""
    cfg, net = COLOR_WIDE[name], color_net(name)
    x, d, g, f = _color_rows(cfg, 70, 11)
    head = torch.cat([torch.zeros(70, 1), f], 1)
    with torch.no_grad():
        got = CK.launch_color_fwd(cfg, pack.pack_color(net), x, d, g, head[:, 1:])
        ref = CK.color_plain(net, x, d, g, f)
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name", sorted(COLOR_WIDE))
def test_emulated_k5_bwd_past_one_warpgroup(emu, name):
    """K5-bwd (the forward and the backward on the one-stage wgmma ring,
    h0_bar in passes of 256 columns, the tensor-core reduction): every
    input's and weight's gradient within 2x the plain f32 version's error
    against f64, or 1e-5; no color cotangent on rows within KINK_MARGIN of a
    ReLU's kink."""
    cfg, net = COLOR_WIDE[name], color_net(name)
    ins = _color_rows(cfg, 70, 12)
    net64 = copy.deepcopy(net).double()
    margin = CK.color_relu_margin(net64, *[t.double() for t in ins])
    rng = np.random.default_rng(13)
    cbar = (torch.from_numpy(rng.standard_normal((70, 3)).astype(np.float32))
            * (margin >= KINK_MARGIN).float()[:, None])
    ws, bs = zip(*pack.effective_layers(net))

    def grads(fn, m, xs, cot):
        xs = [t.clone().requires_grad_(True) for t in xs]
        return torch.autograd.grad(fn(*xs), [*xs, *m.parameters()], cot)

    got = grads(lambda *a: CK.ColorMLP.apply(cfg, pack.pack_color(net), *a, *ws, *bs),
                net, ins, cbar)
    plain = grads(lambda *a: CK.color_plain(net, *a), net, ins, cbar)
    r64 = grads(lambda *a: CK.color_plain(net64, *a), net64, [t.double() for t in ins],
                cbar.double())
    _within_plain(got, plain, r64)


# The render core's nets (K1, K6): every SDF layer, the feature head and the
# color layers past one warpgroup with a color input past 256 columns
# (d_hidden 160, d_feature 232, multires_view 4: k0 = 268, layer 0's tail
# slice, h0_bar's second pass), and a K tail in every GEMM (136).
RENDER_CORE = {
    160: (F.SDFConfig(d_out=233, d_hidden=160, n_layers=4, skip_in=(2,), multires=3,
                      scale=1.3),
          F.ColorConfig(d_feature=232, d_hidden=160, n_layers=3, multires_view=4)),
    136: (F.SDFConfig(d_out=137, d_hidden=136, n_layers=4, skip_in=(2,), multires=3,
                      scale=1.3),
          F.ColorConfig(d_feature=136, d_hidden=136, n_layers=3, multires_view=2)),
}
_RC_NETS = {}


def render_core_nets(hidden):
    if hidden not in _RC_NETS:
        scfg, ccfg = RENDER_CORE[hidden]
        g = torch.Generator().manual_seed(6)
        _RC_NETS[hidden] = (
            perturb_(F.SDFNetwork(scfg, torch.Generator().manual_seed(hidden)), g),
            perturb_(F.ColorNetwork(ccfg, torch.Generator().manual_seed(hidden + 1)), g))
    return _RC_NETS[hidden]


def _render_rows(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    cols = [rng.uniform(-1.2, 1.2, size=(n, 4)), d / np.linalg.norm(d, axis=-1, keepdims=True),
            rng.uniform(-1.2, 1.2, size=(n, 4))]
    return [torch.from_numpy(c.astype(np.float32)) for c in cols]


def test_rendercore_pack_holds_what_the_kernels_read():
    """The render-core pack (K1, K6): the SDF part as the outgrad pack
    holds it and the color part as the color pack does, every matrix as
    wgmma B, the same bytes; no plain copy of any hidden layer or of the
    feature columns; h0_bar's tail only where k0 > 256."""
    for hidden, (scfg, ccfg) in RENDER_CORE.items():
        sdf, col = render_core_nets(hidden)
        s_layers, c_layers = pack.effective_layers(sdf), pack.effective_layers(col)
        params, offs = pack.pack_rendercore_layers(s_layers, c_layers, ccfg)
        tail = {"wct0tp"} if pack.color_k0(ccfg) > 256 else set()
        assert set(offs) == {"b", "wp", "wtp", "w_last0", "b_last0", "wfp", "wftp",
                             "b_feat", "wcp", "wctp", "bc", "wc_last", "wct_last"} | tail
        assert len(offs["wp"]) == len(offs["wtp"]) == len(s_layers) - 1
        assert len(offs["wcp"]) == len(offs["wctp"]) == len(c_layers) - 1
        og, og_offs = pack.pack_outgrad_layers(s_layers)
        cl, cl_offs = pack.pack_color_layers(c_layers, ccfg)
        ends = sorted(v for o in offs.values() for v in (o if isinstance(o, list) else [o]))
        ends.append(params.numel())
        for key, where in offs.items():
            src, src_offs = (cl, cl_offs) if key in cl_offs else (og, og_offs)
            for i, off in enumerate(where if isinstance(where, list) else [where]):
                o2 = src_offs[key] if not isinstance(src_offs[key], list) else src_offs[key][i]
                size = ends[ends.index(off) + 1] - off
                assert torch.equal(params[off:off + size], src[o2:o2 + size]), (hidden, key, i)


@pytest.mark.parametrize("kernel", ["K1", "K6"])
@pytest.mark.parametrize("hidden", [160, 136])
def test_emulated_rendercore_fwd_past_one_warpgroup(emu, kernel, hidden):
    """K1-fwd and K6-fwd (every GEMM on the two-stage wgmma ring: the
    hidden layers, the feature head into the color input, the gradient
    sweep, the color layers; K6 also the value sweep at y) against their
    plain versions: 1e-4, the gradient 1e-4 of its largest entry."""
    scfg, ccfg = RENDER_CORE[hidden]
    sdf, col = render_core_nets(hidden)
    x, d, y = _render_rows(70, 16)
    packed = pack.pack_rendercore(sdf, col)
    with torch.no_grad():
        if kernel == "K1":
            got = RC.launch_fwd(scfg, ccfg, packed, x, d)
            ref = RC.rendercore_fwd_plain(sdf, col, x, d)
        else:
            got = RCC.launch_cons_fwd(scfg, ccfg, packed, x, d, y)
            ref = RCC.rendercore_cons_plain(sdf, col, x, d, y)
    for name, a, b in zip(("sdf", "grad", "color", "sdf_w"), got, ref):
        lim = 1e-4 * (max(1.0, b.abs().max().item()) if name == "grad" else 1.0)
        assert (a - b).abs().max().item() <= lim, name


# Cotangent channels of the render core: sdf, grad, color (and K6's sdf_w).
RC_CHANNELS = {"sbar": (1, 0, 0, 0), "gbar": (0, 1, 0, 0), "cbar": (0, 0, 1, 0),
               "swbar": (0, 0, 0, 1), "all": (1, 1, 1, 1)}


def _rendercore_case(kernel, chan):
    """(inputs, cotangents) of K1-bwd's or K6-bwd's checks at d_hidden 160
    for one cotangent channel (or all): no color cotangent on rows within
    KINK_MARGIN of a color ReLU's kink."""
    sdf, col = render_core_nets(160)
    x, d, y = _render_rows(70, 17)
    ins = [x, d] if kernel == "K1" else [x, d, y]
    rng = np.random.default_rng(18)
    cots = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((70, 1), (70, 4), (70, 3), (70,))]
    margin = RC.color_relu_margin(copy.deepcopy(sdf).double(), copy.deepcopy(col).double(),
                                  x.double(), d.double())
    cots[2] = cots[2] * (margin >= KINK_MARGIN).float()[:, None]
    return ins, [c * m for c, m in zip(cots, RC_CHANNELS[chan])][:len(ins) + 1]


def _rc_grads(fn, nets, xs, cs):
    xs = [t.clone().requires_grad_(True) for t in xs]
    params = [p for m in nets for p in m.parameters()]
    return torch.autograd.grad(fn(*xs), [*xs, *params], cs)


@functools.lru_cache(maxsize=None)
def _kernel_grads(kernel, chan):
    """x_bar, dirs_bar (y_bar) and every parameter's gradient of both nets
    through K1-bwd's or K6-bwd's autograd.Function for ``_rendercore_case``
    (kept: the frozen-fields checks hold K1's against their own)."""
    scfg, ccfg = RENDER_CORE[160]
    sdf, col = render_core_nets(160)
    ins, cots = _rendercore_case(kernel, chan)
    ws, bs = zip(*pack.effective_layers(sdf))
    wc, bc = zip(*pack.effective_layers(col))
    fn = RC.RenderCore if kernel == "K1" else RCC.RenderCoreCons
    packed = pack.pack_rendercore(sdf, col)
    return _rc_grads(lambda *a: fn.apply(scfg, ccfg, packed, *a, *ws, *bs, *wc, *bc),
                     (sdf, col), ins, cots)


def _rendercore_bwd_check(kernel, chan):
    """K1-bwd or K6-bwd (every GEMM on the one-stage wgmma ring, the
    tensor-core reduction) at d_hidden 160 through its autograd.Function for
    one cotangent channel (or all): x_bar, dirs_bar (y_bar) and every
    weight gradient of both nets within 2x the plain f32 version's error
    against f64, or 1e-5; no color cotangent on rows within KINK_MARGIN of
    a color ReLU's kink."""
    sdf, col = render_core_nets(160)
    sdf64, col64 = copy.deepcopy(sdf).double(), copy.deepcopy(col).double()
    ins, cots = _rendercore_case(kernel, chan)
    plain = RC.rendercore_fwd_plain if kernel == "K1" else RCC.rendercore_cons_plain
    ref = _rc_grads(lambda *a: plain(sdf, col, *a), (sdf, col), ins, cots)
    r64 = _rc_grads(lambda *a: plain(sdf64, col64, *a), (sdf64, col64),
                    [t.double() for t in ins], [c.double() for c in cots])
    _within_plain(_kernel_grads(kernel, chan), ref, r64)


@pytest.mark.parametrize("chan", ["sbar", "gbar", "cbar", "all"])
def test_emulated_k1_bwd_past_one_warpgroup(emu, chan):
    _rendercore_bwd_check("K1", chan)


@pytest.mark.parametrize("chan", ["sbar", "gbar", "cbar", "swbar", "all"])
def test_emulated_k6_bwd_past_one_warpgroup(emu, chan):
    _rendercore_bwd_check("K6", chan)



@pytest.mark.parametrize("chan", ["sbar", "gbar", "cbar", "all"])
def test_emulated_k1_bwd_frozen_matches_the_full_kernel(emu, chan):
    """K1-bwd for frozen fields (weights that need no gradient) at d_hidden
    160, through ``RenderCore``'s backward: None for every weight and bias,
    x_bar and dirs_bar the full kernel's bit for bit and within 2x the plain
    f32 version's error against f64, or 1e-5."""
    scfg, ccfg = RENDER_CORE[160]
    sdf, col = render_core_nets(160)
    (x, d), cots = _rendercore_case("K1", chan)
    groups = [*zip(*pack.effective_layers(sdf)), *zip(*pack.effective_layers(col))]
    wb = [t.detach() for g in groups for t in g]
    xs = [t.clone().requires_grad_(True) for t in (x, d)]
    frozen = RC.RenderCore.apply(scfg, ccfg, pack.pack_rendercore(sdf, col), *xs,
                                 *wb)[0].grad_fn.apply(*cots)
    assert len(frozen) == 5 + len(wb)
    assert frozen[:3] == (None, None, None) and all(g is None for g in frozen[5:])
    full = _kernel_grads("K1", chan)
    assert torch.equal(frozen[3], full[0]) and torch.equal(frozen[4], full[1])

    def grads(nets, xs, cs):
        xs = [t.clone().requires_grad_(True) for t in xs]
        return torch.autograd.grad(RC.rendercore_fwd_plain(*nets, *xs), xs, cs)

    sdf64, col64 = copy.deepcopy(sdf).double(), copy.deepcopy(col).double()
    _within_plain(frozen[3:5], grads((sdf, col), (x, d), cots),
                  grads((sdf64, col64), (x.double(), d.double()),
                        [c.double() for c in cots]))


def test_emulated_k1_bwd_one_trainable_color_layer_takes_the_full_kernel(emu):
    """With one color layer trainable and every other weight frozen,
    ``RenderCore`` takes the full K1-bwd: that layer's W and b bars, x_bar
    and dirs_bar within 2x the plain f32 version's error against f64, or
    1e-5."""
    scfg, ccfg = RENDER_CORE[160]
    nets = [copy.deepcopy(m) for m in render_core_nets(160)]
    for p in nets[0].parameters():
        p.requires_grad_(False)
    for name, p in nets[1].named_parameters():
        p.requires_grad_(name.startswith("layers.lin1."))
    params = [p for p in nets[1].parameters() if p.requires_grad]
    nets64 = [copy.deepcopy(m).double() for m in nets]
    params64 = [p for p in nets64[1].parameters() if p.requires_grad]
    (x, d), cots = _rendercore_case("K1", "all")

    def kernel(*xs):
        wb = [*zip(*pack.effective_layers(nets[0])), *zip(*pack.effective_layers(nets[1]))]
        return RC.RenderCore.apply(scfg, ccfg, pack.pack_rendercore(*nets), *xs,
                                   *[t for g in wb for t in g])

    def grads(fn, ps, xs, cs):
        xs = [t.clone().requires_grad_(True) for t in xs]
        return torch.autograd.grad(fn(*xs), [*xs, *ps], cs)

    got = grads(kernel, params, (x, d), cots)
    ref = grads(lambda *a: RC.rendercore_fwd_plain(*nets, *a), params, (x, d), cots)
    r64 = grads(lambda *a: RC.rendercore_fwd_plain(*nets64, *a), params64,
                (x.double(), d.double()), [c.double() for c in cots])
    assert len(params) == 3
    _within_plain(got, ref, r64)
