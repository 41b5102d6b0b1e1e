"""The port's host utilities against the JAX package's: the reference
renderer checkpoint loader (``models/torch_io.py``), the novel-view
trajectories (``ops/trajectories.py``), the camera frustums
(``utils/frustum.py``), the NaN/Inf sentinels (``utils/checks.py``) and the
source backup (``utils/backup.py``).

Every comparison is exact: the trajectories and frustums are copies of the
same numpy code, the loader copies the same tensors (JAX's (in, out) tree
carried across by ``models/exchange.py`` equals the port's (out, in)
layers bit for bit), and the sentinels flag the same planted leaves."""

import logging
import os

import numpy as np
import pytest
import torch

from copenerf_tpu.models import torch_io as JIO
from copenerf_tpu.ops import trajectories as JTR
from copenerf_tpu.utils import checks as JC
from copenerf_tpu.utils import frustum as JFR
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.models import torch_io as TIO
from copenerf_torch.ops import trajectories as TTR
from copenerf_torch.utils import backup as TB
from copenerf_torch.utils import checks as TC
from copenerf_torch.utils import frustum as TFR

# Small widths at the reference's depths (the JAX loader reads 9 SDF, 5
# color and 5 motion layers and 8 NeRF point layers).
CONFIGS = {
    "sdf": TF.SDFConfig(d_out=17, d_hidden=64),
    "color": TF.ColorConfig(d_feature=16, d_hidden=16),
    "motion": TF.MotionConfig(d_hidden=16),
    "nerf": TF.NerfConfig(W=16),
    "variance": TF.VarianceConfig(),
}
NERF_NAMES = {"views0": "views_linears.0", "feature": "feature_linear",
              "alpha": "alpha_linear", "rgb": "rgb_linear"}


def _reference_state_dict(seed=0):
    """A ``DataParallel(NeuSRenderer).state_dict()`` of random weights in the
    reference's layout: ``module.``-prefixed, weight-normed layers as
    ``weight_v`` (out, in) / ``weight_g`` (out, 1) / ``bias``, the NeRF's
    plain ``weight`` / ``bias``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    nets = TF.init_all_fields(CONFIGS, g, device="cpu")
    prefixes = {"sdf": "sdf_network", "color": "color_network",
                "motion": "motion_network", "nerf": "nerf"}
    for key, prefix in prefixes.items():
        for name, layer in nets[key].layers.items():
            ref = NERF_NAMES.get(name, f"pts_linears.{name[3:]}") \
                if key == "nerf" else name
            base = f"module.{prefix}.{ref}"
            if hasattr(layer, "v"):
                sd[f"{base}.weight_v"] = torch.randn(layer.v.shape, generator=g)
                sd[f"{base}.weight_g"] = torch.rand(
                    (layer.g.shape[0], 1), generator=g) + 0.5
            else:
                sd[f"{base}.weight"] = torch.randn(layer.w.shape, generator=g)
            sd[f"{base}.bias"] = torch.randn(layer.b.shape, generator=g)
    sd["module.deviation_network.variance"] = torch.tensor(0.31)
    return sd


def test_reference_renderer_checkpoint_loads_as_in_jax(tmp_path):
    path = str(tmp_path / "model.pt")
    scalars = {"epoch_it": 7, "it": 1234, "loss_val_best": 0.25}
    torch.save({"model": _reference_state_dict(), **scalars}, path)

    port = TIO.load_reference_renderer_checkpoint(path, CONFIGS, device="cpu")
    jax_side = JIO.load_reference_renderer_checkpoint(path)
    assert port["scalars"] == jax_side["scalars"] == scalars
    tree = {k: {lk: {pk: np.asarray(v) for pk, v in lv.items()}
                for lk, lv in sub.items()} if k != "variance"
            else {"variance": np.asarray(sub["variance"])}
            for k, sub in jax_side["params"].items()}
    carried = X.params_from_jax(tree, CONFIGS, device="cpu")
    got = dict(port["fields"].named_parameters())
    want = dict(carried.named_parameters())
    assert set(got) == set(want)
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    # The state dict's tensors arrive unchanged in the port's layout.
    sd = _reference_state_dict()
    sdf = port["fields"]["sdf"].layers
    assert torch.equal(sdf["lin3"].v, sd["module.sdf_network.lin3.weight_v"])
    assert torch.equal(sdf["lin3"].g,
                       sd["module.sdf_network.lin3.weight_g"].reshape(-1))
    nerf = port["fields"]["nerf"].layers
    assert torch.equal(nerf["pts5"].w, sd["module.nerf.pts_linears.5.weight"])
    assert torch.equal(nerf["rgb"].b, sd["module.nerf.rgb_linear.bias"])


def test_reference_checkpoint_without_a_network_raises(tmp_path):
    sd = {k: v for k, v in _reference_state_dict().items()
          if not k.startswith("module.nerf.")}
    path = str(tmp_path / "model.pt")
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="nerf"):
        TIO.load_reference_renderer_checkpoint(path, CONFIGS, device="cpu")


def _poses(n=7, seed=0):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    c2w = np.zeros((n, 4, 4), np.float32)
    c2w[:, :3, :3] = Rotation.from_rotvec(
        rng.normal(size=(n, 3)) * 0.3).as_matrix()
    c2w[:, :3, 3] = rng.normal(size=(n, 3))
    c2w[:, 3, 3] = 1
    return c2w


def _trajectory_cases():
    c2w = _poses()
    rng = np.random.default_rng(1)
    hwf = np.tile(np.array([[[540.0], [960.0], [600.0]]]), (7, 1, 1))
    rays_o, rays_d = rng.normal(size=(2, 50, 3))
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.1
    return {
        "convert3x4_4x4": lambda m: m.convert3x4_4x4(c2w[:, :3]),
        "convert3x4_4x4_single": lambda m: m.convert3x4_4x4(c2w[0, :3]),
        "interp_poses": lambda m: m.interp_poses(c2w, 19),
        "bspline": lambda m: m.bspline(c2w[:, :3, 3], n=33),
        "interp_poses_bspline": lambda m: m.interp_poses_bspline(
            c2w, 25, np.linspace(0, 1, 7)),
        "poses_avg": lambda m: m.poses_avg(
            np.concatenate([c2w[:, :3, :4], hwf], -1)),
        "generate_spiral_path": lambda m: m.generate_spiral_path(
            c2w, np.array([0.5, 4.0]), 12, hwf),
        "get_ndc_rays_fxfy": lambda m: m.get_ndc_rays_fxfy(
            (1.1, 0.9), 1.0, rays_o, rays_d),
        "create_spheric_poses": lambda m: m.create_spheric_poses(2.0, 0.1, 16),
    }


@pytest.mark.parametrize("name", sorted(_trajectory_cases()))
def test_trajectories_match_jax_exactly(name):
    case = _trajectory_cases()[name]
    got, want = case(TTR), case(JTR)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_frustums_match_jax_exactly(tmp_path):
    c2w = _poses()
    for kw in ({}, {"fov_deg": 70.0, "frustum_length": 0.3}):
        for g, w in zip(TFR.frustum_lines(c2w, **kw),
                        JFR.frustum_lines(c2w, **kw)):
            np.testing.assert_array_equal(g, w)
    TFR.write_frustums_ply(str(tmp_path / "port.ply"), c2w, color=(0, 9, 200))
    JFR.write_frustums_ply(str(tmp_path / "jax.ply"), c2w, color=(0, 9, 200))
    assert (open(tmp_path / "port.ply").read()
            == open(tmp_path / "jax.ply").read())


def _jax_name_to_port(name):
    """``['sdf']['lin0']['v']`` -> ``sdf.layers.lin0.v``; the variance's
    ``['variance']['variance']`` -> ``variance.variance``."""
    keys = [k.strip("'") for k in name.strip("[]").split("][")]
    if keys[0] == "variance":
        return "variance.variance"
    return f"{keys[0]}.layers.{keys[1]}.{keys[2]}"


def test_check_params_flags_the_planted_leaves_as_jax(caplog):
    fields = TF.init_all_fields(CONFIGS, torch.Generator().manual_seed(0),
                                device="cpu")
    with torch.no_grad():
        fields["sdf"].layers["lin2"].v[3, 1] = float("nan")
        fields["color"].layers["lin0"].b[0] = float("nan")
        fields["variance"].variance.fill_(float("nan"))
        # Inf is not NaN: neither package flags it in a parameter.
        fields["nerf"].layers["pts1"].w[0, 0] = float("inf")
    with caplog.at_level(logging.WARNING):
        bad = TC.check_params(fields)
    want = {"sdf.layers.lin2.v", "color.layers.lin0.b", "variance.variance"}
    assert set(bad) == want
    assert sum("NaN values in param" in r.message for r in caplog.records) == 3
    jax_bad = JC.check_params(X.params_to_jax(fields))
    assert {_jax_name_to_port(n) for n in jax_bad} == want
    # One module: its own parameter names.
    assert TC.check_params(fields["sdf"]) == ["layers.lin2.v"]
    assert TC.check_params(fields["motion"]) == []


@pytest.mark.parametrize("value", [0.0, float("nan"), float("inf"),
                                   -float("inf")])
def test_check_tensor_as_jax(value, caplog):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    arr[1, 2] = value if value else arr[1, 2]
    with caplog.at_level(logging.WARNING):
        got = TC.check_tensor(torch.from_numpy(arr), "x")
    assert got == JC.check_tensor(arr, "x") == (not np.isfinite(value))
    assert any("Tensor x" in r.message for r in caplog.records) == got
    assert TC.check_tensor(torch.arange(5), "ints") is False


def test_backup_copies_the_sources_without_builds(tmp_path):
    cfg = tmp_path / "scene.yaml"
    cfg.write_text("training: {}\n")
    dst = TB.backup(str(tmp_path / "out"), str(cfg))
    pkg = os.path.join(dst, "copenerf_torch")
    assert os.path.isfile(os.path.join(dst, "scene.yaml"))
    assert os.path.isfile(os.path.join(pkg, "csrc", "sdf_value.cu"))
    assert os.path.isfile(os.path.join(pkg, "csrc", "wgmma_tile.cuh"))
    assert os.path.isfile(os.path.join(pkg, "mesher", "csrc", "marching.cpp"))
    assert os.path.isfile(os.path.join(pkg, "cli.py"))
    for root, dirs, files in os.walk(pkg):
        assert "_build" not in dirs and "__pycache__" not in dirs
        assert not [f for f in files if f.endswith((".so", ".o"))]
    # A second backup replaces the first.
    assert TB.backup(str(tmp_path / "out")) == dst
