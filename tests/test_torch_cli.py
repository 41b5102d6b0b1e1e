"""The port's entry points (``copenerf_torch/cli.py``) and
``Trainer.extract_geometry`` against the JAX package's.

One checkpoint is written by the JAX ``Trainer`` on the small scene of
``tests/test_cli.py`` (``_tiny_cfg``), its SDF's geometric init perturbed so
that the zero level set is not a sphere. The port's ``Trainer(cfg,
device="cpu")`` reads it and meshes it at resolution 32: the grid points are
the JAX ones bit for bit and the two meshers are the same, so the two
meshes have the same triangles, and their vertices differ only by the SDF
values' f32 rounding (the port's plain PyTorch MLP against XLA's): within
1e-5.

The CLI guards are the JAX package's (``tests/test_cli.py``), plus the port's
``--device``: it defaults to ``cuda``, so without a card every main raises
``resolve_device``'s error before it writes anything."""

import os

import numpy as np
import pytest
import yaml

from copenerf_tpu.config.loader import load_config as j_load_config
from copenerf_tpu.training import trainer as JT
from copenerf_torch import cli
from copenerf_torch.config.loader import load_config
from copenerf_torch.training import trainer as TT
from test_cli import _tiny_cfg

TIME = 0.3
RES = 32


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(config path, {time: JAX mesh}) of a checkpoint the JAX Trainer
    wrote, its SDF perturbed."""
    import jax

    tmp = tmp_path_factory.mktemp("jax_run")
    cfg_path = _tiny_cfg(tmp)
    trainer = JT.Trainer(j_load_config(cfg_path), verbose=False)
    rng = np.random.default_rng(0)
    sdf = jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf) * (1.0 + 0.3 * rng.standard_normal(
            np.shape(leaf))).astype(np.float32),
        trainer.state["params"]["sdf"])
    trainer.state = {**trainer.state,
                     "params": {**trainer.state["params"], "sdf": sdf}}
    trainer.save_checkpoint()
    meshes = {t: trainer.extract_geometry(resolution=RES, time_step=t)
              for t in (None, TIME)}
    return cfg_path, meshes


@pytest.mark.parametrize("time_step", [None, TIME])
def test_extract_geometry_matches_jax(run, time_step):
    cfg_path, meshes = run
    trainer = TT.Trainer(load_config(cfg_path), device="cpu", verbose=False)
    assert trainer.checkpoint_loaded
    verts, tris = trainer.extract_geometry(resolution=RES,
                                           time_step=time_step)
    j_verts, j_tris = meshes[time_step]
    assert len(tris) > 100
    np.testing.assert_array_equal(tris, j_tris)
    assert verts.dtype == j_verts.dtype == np.float32
    np.testing.assert_allclose(verts, j_verts, rtol=0, atol=1e-5)


def test_extract_geometry_is_not_a_sphere(run):
    """The perturbation took: the level set's radius varies by far more
    than a voxel (2.4 / 31)."""
    verts, _ = run[1][None]
    radii = np.linalg.norm(verts, axis=-1)
    assert radii.max() - radii.min() > 0.2


def test_extract_mesh_main_matches_extract_geometry(run, tmp_path):
    cfg_path, meshes = run
    out = str(tmp_path / "mesh.ply")
    cli.extract_mesh_main([cfg_path, "--device", "cpu", "--resolution",
                           str(RES), "--time-step", str(TIME), "--out", out])
    verts, tris = meshes[TIME]
    with open(out, "rb") as f:
        blob = f.read()
    header = blob[:blob.index(b"end_header\n")].decode("ascii")
    assert f"element vertex {len(verts)}" in header
    assert f"element face {len(tris)}" in header


def test_extract_mesh_refuses_without_checkpoint(tmp_path):
    cfg_path = _tiny_cfg(tmp_path)
    with pytest.raises(SystemExit) as exc_info:
        cli.extract_mesh_main([cfg_path, "--device", "cpu",
                               "--resolution", "16"])
    assert "No checkpoint" in str(exc_info.value)
    assert not os.path.exists(tmp_path / "out" / "mesh.ply")


@pytest.mark.parametrize("bad", ["1.5", "-2.0"])
def test_extract_mesh_rejects_out_of_range_time_step(tmp_path, bad):
    cfg_path = _tiny_cfg(tmp_path)
    with pytest.raises(SystemExit):
        cli.extract_mesh_main([cfg_path, "--device", "cpu",
                               "--time-step", bad])


@pytest.mark.parametrize("command", ["train", "eval", "extract-mesh", "bench"])
def test_mains_default_to_cuda(tmp_path, command, monkeypatch):
    """Without a card the default device raises before anything is
    written: no config copy, no backup, no mesh."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = _tiny_cfg(tmp_path)
    argv = [command] if command == "bench" else [command, cfg_path]
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "out")


def test_unknown_command_exits():
    with pytest.raises(SystemExit):
        cli.main(["mesh"])


def test_train_then_extract_mesh_round_trip(tmp_path):
    """``train_main --max-epochs 1 --device cpu`` writes the config copy,
    the source backup (without ``_build``) and a checkpoint, and
    ``extract_mesh_main`` meshes that checkpoint."""
    cfg_path = _tiny_cfg(tmp_path)
    cfg = yaml.safe_load(open(cfg_path))
    cfg["training"].update({
        "n_training_points": 64, "patch_size": 4, "scheduling_start": 1,
        "scheduling_epoch": 1, "pretrained_sdf_path": None,
        "depth_bound_update_every_milestones": [0, 0, 0]})
    # Trainable small widths (those of test_torch_trainer.py): the color
    # net reads the SDF's feature, d_out = 1 + d_feature.
    cfg["neus_sdf_network"] = {"d_hidden": 64, "n_layers": 4, "skip_in": [2],
                               "d_out": 33}
    cfg["neus_rendering_network"] = {"d_feature": 32, "d_hidden": 32,
                                     "n_layers": 2}
    cfg["motion_network"] = {"d_hidden": 32, "n_layers": 2, "skip_in": [1]}
    cfg["rendering"] = {"depth_range": [0.5, 3.5]}
    cfg["neus_renderer"] = {"n_samples": 16, "n_importance": 16,
                            "up_sample_steps": 2}
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    cli.train_main([cfg_path, "--max-epochs", "1", "--device", "cpu"])
    out_dir = tmp_path / "out"
    assert (out_dir / "cfg.yaml").is_file()
    backup = out_dir / "backup" / "copenerf_torch"
    assert (backup / "cli.py").is_file()
    assert (backup / "csrc" / "sdf_value.cu").is_file()
    assert not (backup / "_build").exists()
    assert (out_dir / "models" / "weights" / "model.ckpt.npz").is_file()

    cli.extract_mesh_main([cfg_path, "--device", "cpu", "--resolution", "16"])
    with open(out_dir / "mesh.ply", "rb") as f:
        assert f.read(4) == b"ply\n"
