"""The render slice as a whole: ``ImageRenderer.render_image`` of the port
against the JAX package's at a small width, over several chunks with a
padded tail, with weights exchanged directly and through a JAX checkpoint
on disk. Composited outputs (color, depth, normal) agree to f32 rounding
amplified by the importance chain: 5e-5."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from copenerf_tpu.evaluation.render import ImageRenderer as JImageRenderer
from copenerf_tpu.models import fields as JF
from copenerf_tpu.ops.renderer import RendererConfig as JRendererConfig
from copenerf_tpu.training.checkpoints import save_checkpoint
from copenerf_tpu.training.step import init_train_state
from copenerf_torch.evaluation.render import ImageRenderer
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.ops.renderer import RendererConfig
from copenerf_torch.training.checkpoints import load_checkpoint, load_fields

JCFGS = {
    "sdf": JF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4,
                        skip_in=(2,), multires=3),
    "color": JF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                            multires_view=2),
    "motion": JF.MotionConfig(d_hidden=32, n_layers=4, skip_in=(2,),
                              multires=3),
    "nerf": JF.NerfConfig(D=4, W=32, multires=3, multires_view=2,
                          skips=(2,)),
    "variance": JF.VarianceConfig(),
}
TCFGS = {k: getattr(TF, type(v).__name__)(**dataclasses.asdict(v))
         for k, v in JCFGS.items()}
RCFG = dict(n_samples=16, n_importance=16, up_sample_steps=4)
RES = (6, 10)          # 60 pixels: chunk 16 -> 4 chunks, 4 padded rays
CHUNK = 16
ATOL = 5e-5

K = np.array([[2 * 8.0 / 10, 0, 0, 0], [0, -2 * 8.0 / 6, 0, 0],
              [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)
W2C = np.eye(4, dtype=np.float32)
W2C[2, 3] = -2.0       # camera at z = +2 looking down -z at the init sphere
SCALE = np.eye(4, dtype=np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return JF.init_all_fields(jax.random.PRNGKey(2), JCFGS)


def _render_both(jp, fields, world_mat=W2C, t=0.05):
    jr = JImageRenderer(JCFGS, JRendererConfig(**RCFG), chunk=CHUNK)
    tr = ImageRenderer(RendererConfig(**RCFG), chunk=CHUNK, device="cpu")
    assert (jr.min_chunk, jr.chunk) == (tr.min_chunk, tr.chunk)
    args = (K, world_mat, SCALE, t, RES, (0.5, 4.0), 0.6)
    return (jr.render_image(jp, *args, want_pts=True),
            tr.render_image(fields, *args, want_pts=True))


def _compare(ref, got):
    assert set(got) == set(ref)
    for k in ("color", "depth", "weighted_z", "normal"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    # depth_highest takes the argmax sample: equal unless two samples tie
    # within rounding, which these inputs do not hit.
    np.testing.assert_allclose(got["depth_highest"], ref["depth_highest"],
                               rtol=0, atol=5e-4)
    assert got["weights_flat"].shape == ref["weights_flat"].shape


def test_render_image_matches_jax(jax_params):
    fields = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                               TCFGS, device="cpu")
    ref, got = _render_both(jax_params, fields)
    _compare(ref, got)
    assert np.mean(got["depth"] < 2.0) > 0.3   # the sphere is in view


def test_render_image_rotated_world_mat(jax_params):
    """A non-identity world_mat rotates normals and depth_highest."""
    fields = X.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                               TCFGS, device="cpu")
    c, s = np.cos(0.2), np.sin(0.2)
    w2c = W2C.copy()
    w2c[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    ref, got = _render_both(jax_params, fields, world_mat=w2c, t=-0.1)
    _compare(ref, got)


def test_jax_checkpoint_renders_in_port(jax_params, tmp_path):
    state = init_train_state(jax_params)
    save_checkpoint(str(tmp_path), state, {"it": 7, "epoch_it": 1})
    tree, scalars = load_checkpoint(str(tmp_path))
    assert scalars == {"it": 7, "epoch_it": 1}
    assert set(tree) == {"params", "opt_fields", "opt_motion"}
    fields = load_fields(str(tmp_path), TCFGS, device="cpu")
    assert isinstance(fields["sdf"], TF.SDFNetwork)
    ref, got = _render_both(jax_params, fields)
    _compare(ref, got)


def test_entry_points_default_to_cuda():
    """Without a card the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageRenderer(RendererConfig(**RCFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.init_all_fields(TCFGS)
