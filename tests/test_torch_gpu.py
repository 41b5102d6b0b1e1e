"""The port's CUDA kernels on the card, held against their plain PyTorch
versions. Marked ``gpu``: each test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so on the H100 (which has no JAX) it
runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 in both versions, summed in another order; sdf and color
1e-4 absolute, grad 1e-4 x max(1, max|grad|). The nets are the geometric
init perturbed by ``perturb_``, so the PE columns are not zero and the SDF
head's columns differ: a fault in the PE or in the column order shows."""

import numpy as np
import pytest
import torch

from copenerf_torch.evaluation.render import ImageRenderer
from copenerf_torch.models import fields as TF
from copenerf_torch.models.mlp import perturb_
from copenerf_torch.ops.kernels import rendercore as RC
from copenerf_torch.ops.kernels import sdf_value as SV
from copenerf_torch.ops.renderer import RendererConfig

WIDTHS = {
    "full": (TF.SDFConfig(), TF.ColorConfig()),
    "small": (TF.SDFConfig(d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                           multires=3),
              TF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                             multires_view=2)),
}


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the H100)")


def _nets(width, device):
    scfg, ccfg = WIDTHS[width]
    nets = (TF.SDFNetwork(scfg, torch.Generator().manual_seed(0)),
            TF.ColorNetwork(ccfg, torch.Generator().manual_seed(1)))
    g = torch.Generator().manual_seed(2)
    return tuple(perturb_(net, g).to(device) for net in nets)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, size=(n, 4)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(x).cuda(), torch.from_numpy(d).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_kernels_match_plain_on_card(width, n):
    _require_cuda()
    sdf_net, color_net = _nets(width, "cuda")
    x, d = _rows(n, seed=n)
    with torch.no_grad():
        v = SV.sdf_value_cuda(sdf_net, x)
        torch.testing.assert_close(v, SV.sdf_value_plain(sdf_net, x),
                                   rtol=0, atol=1e-4)
        got = RC.rendercore_fwd_cuda(sdf_net, color_net, x, d)
        ref = RC.rendercore_fwd_plain(sdf_net, color_net, x, d)
    for name, g, r in zip(("sdf", "grad", "color"), got, ref):
        tol = 1e-4 * (max(1.0, r.abs().max().item()) if name == "grad" else 1)
        torch.testing.assert_close(g, r, rtol=0, atol=tol, msg=name)


@pytest.mark.gpu
def test_kernels_refuse_grad_mode_on_card():
    _require_cuda()
    sdf_net, color_net = _nets("small", "cuda")
    x, d = _rows(8, seed=0)
    with pytest.raises(RuntimeError, match="training slice"):
        SV.sdf_value_cuda(sdf_net, x)
    with pytest.raises(RuntimeError, match="training slice"):
        RC.rendercore_fwd_cuda(sdf_net, color_net, x, d)


@pytest.mark.gpu
def test_render_image_card_matches_cpu():
    """The whole render path at a small width, several chunks and a padded
    tail, on the card (kernels) and on the CPU (plain versions)."""
    _require_cuda()
    rcfg = RendererConfig(n_samples=16, n_importance=16, up_sample_steps=4)
    K = np.array([[1.6, 0, 0, 0], [0, -2.6, 0, 0], [0, 0, -1, 0],
                  [0, 0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = -2.0
    out = {}
    for dev in ("cuda", "cpu"):
        sdf_net, color_net = _nets("small", dev)
        fields = torch.nn.ModuleDict({
            "sdf": sdf_net, "color": color_net,
            "variance": TF.VarianceNetwork(TF.VarianceConfig()).to(dev)})
        out[dev] = ImageRenderer(rcfg, chunk=16, device=dev).render_image(
            fields, K, w2c, np.eye(4, dtype=np.float32), 0.1, (6, 10),
            (0.5, 4.0), 0.6)
    for k in ("color", "depth", "normal"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=0,
                                   atol=2e-3, err_msg=k)
