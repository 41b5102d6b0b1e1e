"""Port parity for K7, the SDF output with a first-order backward
(``copenerf_torch/ops/kernels/sdf_out.py``), reached through
``fields.sdf_output``.

On the CPU ``sdf_output`` takes ``sdf_out_plain`` (``sdf_apply`` under
autograd); its forward and its VJP (for the head's column 0 alone, its
feature columns alone and all of it) are held against ``jax.vjp`` of the JAX
package's ``get_fused_ops(...).out`` with the Pallas kernels in interpret
mode and against ``jax.vjp`` of its ``sdf_apply``, at ragged row counts (the
JAX kernel pads to its tile of 8). Weight gradients are compared in the JAX
layout. K7-bwd's gradient buffer (the value layout with the whole head) is
checked by an unpack of a known buffer. The CUDA kernels themselves are held
against the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances as ``test_torch_train_kernels.py``: outputs and x_bar 2e-5
absolute (x_bar: 2e-5 of max(1, its largest entry), which matters at full
width only), weight gradients 1e-5 relative to the largest entry of each
tensor plus 2e-5.
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
from copenerf_torch.ops.kernels import pack
from copenerf_torch.ops.kernels import sdf_out as SO
from test_torch_train_kernels import ATOL, assert_tree_close, grads_as_jax, rows

CONFIGS = {
    "small": JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4,
                          skip_in=(2,), multires=3, bias=0.5, scale=1.3),
    "full": JF.SDFConfig(),
}
WIDTHS = ["small", pytest.param("full", marks=pytest.mark.slow)]


@pytest.fixture(scope="module")
def nets():
    """{width: (JAX params, torch net)}: the JAX init, perturbed
    (``perturb_``) so that the PE columns and the head's columns differ;
    the full width is built on first use."""
    cache = {}

    def get(width):
        if width not in cache:
            cfg = CONFIGS[width]
            jp = {"sdf": JF.sdf_init(jax.random.PRNGKey(11), cfg)}
            tp = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   {"sdf": TF.SDFConfig(**dataclasses.asdict(cfg))},
                                   device="cpu")
            perturb_(tp, torch.Generator().manual_seed(12))
            cache[width] = (X.params_to_jax(tp)["sdf"], tp["sdf"])
        return cache[width]
    return get


def _head_mask(d_out, channel):
    m = np.zeros(d_out, np.float32)
    if channel in ("sdf", "all"):
        m[0] = 1.0
    if channel in ("feature", "all"):
        m[1:] = 1.0
    return m


def _torch_vjp(net, x, obar):
    for p in net.parameters():
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TF.sdf_output(net, xt)
    out.backward(torch.from_numpy(obar))
    return out.detach().numpy(), xt.grad.numpy(), grads_as_jax(net)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("reference", ["pallas", "sdf_apply"])
@pytest.mark.parametrize("channel", ["sdf", "feature", "all"])
@pytest.mark.parametrize("n", [13, 21])
def test_sdf_output_vjp_matches_jax(nets, width, reference, channel, n):
    """out, x_bar and every W/b bar of the SDF net for the head's
    cotangent on column 0, on the feature columns and on all of it."""
    jp, net = nets(width)
    cfg = CONFIGS[width]
    x, _ = rows(n, seed=100 + n)
    obar = (np.random.default_rng(101).normal(size=(n, cfg.d_out))
            .astype(np.float32) * _head_mask(cfg.d_out, channel))
    fn = (get_fused_ops(cfg, tile=8, interpret=True).out if reference == "pallas"
          else lambda p, xx: JF.sdf_apply(cfg, p, xx))
    ref_out, vjp = jax.vjp(fn, jp, jnp.asarray(x))
    ref_p, ref_x = vjp(jnp.asarray(obar))
    out, x_bar, got_p = _torch_vjp(net, x, obar)
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=0, atol=ATOL,
                               err_msg="out")
    # x_bar sums 257 + 8 x 256 products a row: at full width its entries
    # reach ~20, so the bound scales with them.
    np.testing.assert_allclose(
        x_bar, np.asarray(ref_x), rtol=0,
        atol=ATOL * max(1.0, float(np.abs(ref_x).max())), err_msg="x_bar")
    assert_tree_close(got_p, ref_p, f"{reference} {channel}")


@pytest.mark.parametrize("width", ["small", "full"])
def test_sdf_out_grad_layout(width):
    """K7-bwd's buffer: per SDF layer W_bar (out, in) and b_bar, the last
    layer whole (d_out rows), each read from its own slot."""
    cfg = TF.SDFConfig(**dataclasses.asdict(CONFIGS[width]))
    offs, size = pack.sdf_value_grad_layout(cfg, cfg.d_out)
    buf = torch.arange(size, dtype=torch.float32)
    bars = pack.unpack_sdf_value_grads(buf, offs, cfg, cfg.d_out)
    shapes = pack._layer_shapes(cfg)
    assert [tuple(w.shape) for w, _ in bars] == shapes
    assert shapes[-1][0] == cfg.d_out
    for l, ((w, b), (o, i)) in enumerate(zip(bars, shapes)):
        torch.testing.assert_close(w.reshape(-1), buf[offs["gw"][l]:offs["gw"][l] + o * i])
        torch.testing.assert_close(b, buf[offs["gb"][l]:offs["gb"][l] + o])
    # The value layout (K3-bwd) is the same with the head's row 0 alone.
    v_offs, v_size = pack.sdf_value_grad_layout(cfg)
    assert v_offs["gw"] == offs["gw"] and v_offs["gb"][:-1] == offs["gb"][:-1]
    assert v_size < size


def test_sdf_out_cuda_entries_refuse_cpu_tensors(nets):
    """The K7 launchers never compute on a CPU tensor: they raise."""
    _, net = nets("small")
    x = torch.from_numpy(rows(8, seed=102)[0])
    cfg = net.cfg
    with torch.no_grad():
        packed = pack.pack_outgrad(net)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SO.launch_out_fwd(cfg, packed, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SO.sdf_out_bwd_cuda(cfg, packed, x, torch.zeros(8, cfg.d_out))
