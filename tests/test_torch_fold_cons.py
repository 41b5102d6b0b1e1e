"""Port parity for K6, the render-core query with the sdf-consistency
re-query folded into the same launches
(``copenerf_torch/ops/kernels/rendercore_cons.py``).

On the CPU ``rendercore_cons`` takes ``rendercore_cons_plain`` (K1's plain
version on (x, dirs), K3's on y) under autograd; its four outputs and its
VJP (x_bar, dirs_bar, y_bar and every W/b bar of both nets, for each
cotangent alone and all four together) are held against ``jax.vjp`` of the
JAX package's ``get_fused_rendercore_cons`` with the Pallas kernels in
interpret mode, at a ragged row count (13 rows; the JAX side pads to its
tile of 8). The routing switch ``COPENERF_FOLD_CONS`` leaves CPU tensors on
the plain composition, as the JAX package leaves them off the TPU. K6-bwd
writes K1-bwd's gradient layout, which both row sets feed. The CUDA kernels
themselves are held against the plain version on the card
(``test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances as ``test_torch_train_kernels.py``: inputs' cotangents and
outputs 2e-5 absolute, weight gradients 1e-5 relative to the largest entry
of each tensor plus 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.ops.pallas.rendercore_kernels import get_fused_rendercore_cons
from copenerf_torch.models import fields as TF
from copenerf_torch.ops.kernels import pack
from copenerf_torch.ops.kernels import rendercore_cons as RCC
from test_torch_train_kernels import (ATOL, COLOR, SDF, _random_bars, _zero_grads,
                                      assert_tree_close, grads_as_jax, nets, rows)

CHANNELS = {"sbar": (1, 0, 0, 0), "gbar": (0, 1, 0, 0), "cbar": (0, 0, 1, 0),
            "swbar": (0, 0, 0, 1), "all": (1, 1, 1, 1)}
OUTPUTS = ("sdf", "grad", "color", "sdf_w")


@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_rendercore_cons_vjp_matches_pallas(nets, channel):
    """The four outputs, x_bar, dirs_bar, y_bar and every W/b bar of both
    nets, for each cotangent alone and all four, at 13 rows."""
    jp, tp = nets
    n = 13
    x, d = rows(n, seed=90)
    y, _ = rows(n, seed=91)
    rng = np.random.default_rng(92)
    cots = [rng.normal(size=s).astype(np.float32) * m
            for s, m in zip(((n, 1), (n, 4), (n, 3), (n,)), CHANNELS[channel])]
    fn = get_fused_rendercore_cons(SDF, COLOR, tile_fwd=8, tile_bwd=8,
                                   interpret=True)
    ref_out, vjp = jax.vjp(fn, jp["sdf"], jp["color"], *map(jnp.asarray, (x, d, y)))
    ref_sdf, ref_color, ref_x, ref_d, ref_y = vjp(tuple(map(jnp.asarray, cots)))

    sdf_net, color_net = tp["sdf"], tp["color"]
    _zero_grads(sdf_net, color_net)
    xt, dt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, d, y))
    got = RCC.rendercore_cons(sdf_net, color_net, xt, dt, yt)
    for name, g, r in zip(OUTPUTS, got, ref_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL, err_msg=name)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, t, r in (("x_bar", xt, ref_x), ("dirs_bar", dt, ref_d),
                       ("y_bar", yt, ref_y)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL, err_msg=name)
    assert_tree_close(grads_as_jax(sdf_net), ref_sdf, f"{channel} sdf")
    assert_tree_close(grads_as_jax(color_net), ref_color, f"{channel} color")


def test_fold_switch_keeps_cpu_tensors_plain(nets, monkeypatch):
    """``sdf_grad_color_cons`` on CPU tensors gives bit-identical outputs
    and gradients with and without ``COPENERF_FOLD_CONS=1``: both are the
    plain composition."""
    _, tp = nets
    sdf_net, color_net = tp["sdf"], tp["color"]
    x, d = rows(9, seed=93)
    y, _ = rows(9, seed=94)

    def run():
        _zero_grads(sdf_net, color_net)
        ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, d, y)]
        out = TF.sdf_grad_color_cons(sdf_net, color_net, *ins)
        (out[0].sum() + out[1].square().sum() + out[2].sum()
         + out[3].sum()).backward()
        return ([o.detach() for o in out] + [t.grad for t in ins]
                + [p.grad.clone() for net in (sdf_net, color_net)
                   for p in net.parameters()])

    monkeypatch.delenv("COPENERF_FOLD_CONS", raising=False)
    off = run()
    monkeypatch.setenv("COPENERF_FOLD_CONS", "1")
    on = run()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("width", ["small", "full"])
def test_cons_grad_layout_round_trip(width):
    """K6-bwd's buffer is K1-bwd's layout: pack then unpack is the identity,
    and the x rows' and the y rows' bars (the y query touches the SDF net
    alone, the head's row 0 only) summed in the buffer unpack to their sum."""
    if width == "full":
        scfg, ccfg = TF.SDFConfig(), TF.ColorConfig()
    else:
        scfg = TF.SDFConfig(**dataclasses.asdict(SDF))
        ccfg = TF.ColorConfig(**dataclasses.asdict(COLOR))
    offs, size = RCC.rendercore_grad_layout(scfg, ccfg)
    sdf_x, color_x = _random_bars(scfg, 4), _random_bars(ccfg, 5)
    sdf_y = _random_bars(scfg, 6)
    w_last, b_last = sdf_y[-1]
    sdf_y[-1] = (torch.cat([w_last[:1], torch.zeros_like(w_last[1:])]),
                 torch.cat([b_last[:1], torch.zeros_like(b_last[1:])]))
    color_y = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in color_x]
    buf_x = pack.pack_rendercore_grads(sdf_x, color_x, scfg, ccfg)
    buf_y = pack.pack_rendercore_grads(sdf_y, color_y, scfg, ccfg)
    assert buf_x.numel() == size
    got_s, got_c = RCC.unpack_rendercore_grads(buf_x, offs, scfg, ccfg)
    for (gw, gb), (w, b) in zip(got_s + got_c, sdf_x + color_x):
        torch.testing.assert_close(gw, w, rtol=0, atol=0)
        torch.testing.assert_close(gb, b, rtol=0, atol=0)
    got_s, got_c = RCC.unpack_rendercore_grads(buf_x + buf_y, offs, scfg, ccfg)
    for (gw, gb), (wx, bx), (wy, by) in zip(got_s + got_c, sdf_x + color_x,
                                            sdf_y + color_y):
        torch.testing.assert_close(gw, wx + wy, rtol=0, atol=0)
        torch.testing.assert_close(gb, bx + by, rtol=0, atol=0)


def test_cons_cuda_entries_refuse_cpu_tensors(nets):
    """The K6 launchers never compute on a CPU tensor: they raise."""
    _, tp = nets
    x, d = (torch.from_numpy(a) for a in rows(8, seed=95))
    scfg, ccfg = tp["sdf"].cfg, tp["color"].cfg
    with torch.no_grad():
        packed = pack.pack_rendercore(tp["sdf"], tp["color"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        RCC.launch_cons_fwd(scfg, ccfg, packed, x, d, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RCC.rendercore_cons_bwd_cuda(scfg, ccfg, packed, x, d, x,
                                     torch.zeros(8, 1), torch.zeros(8, 4),
                                     torch.zeros(8, 3), torch.zeros(8))
