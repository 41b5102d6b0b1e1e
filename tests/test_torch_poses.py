"""Port parity for the pose modules (``copenerf_torch.poses``) against the
JAX package: Lie helpers, rotation conversions, the pose retriever and the
motion chain. f32 throughout; the motion chain composes 10 Euler substeps
per frame and chains frames sequentially where JAX uses an associative scan,
so it gets 1e-5 (rounding order), the closed forms 2e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.models import fields as JF
from copenerf_tpu.poses import lie as JL
from copenerf_tpu.poses import motion as JM
from copenerf_tpu.poses import retriever as JRt
from copenerf_tpu.poses import rotations as JRo
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.poses import lie as TL
from copenerf_torch.poses import motion as TM
from copenerf_torch.poses import retriever as TRt
from copenerf_torch.poses import rotations as TRo

MOTION = JF.MotionConfig(d_hidden=32, n_layers=4, skip_in=(2,), multires=3,
                         scale=1.0)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def test_lie():
    r = rnd(6, 3, seed=1)
    r[0] = 0.0
    r[1] = 1e-4
    tr = rnd(6, 3, seed=2)
    close(TL.vec2skew(t(r)), JL.vec2skew(jnp.asarray(r)), 0)
    close(TL.exp_so3(t(r)), JL.exp_so3(jnp.asarray(r)), 2e-6)
    m = TL.make_c2w(t(r), t(tr))
    close(m, JL.make_c2w(jnp.asarray(r), jnp.asarray(tr)), 2e-6)
    close(TL.se3_inverse(m), JL.se3_inverse(jnp.asarray(m.numpy())), 2e-6)
    close(TL.se3_inverse(m) @ m, np.broadcast_to(np.eye(4), (6, 4, 4)), 2e-6)


def test_rotations():
    e = rnd(8, 3, seed=3, scale=0.5)
    mt = TRo.euler_angles_to_matrix(t(e), "XYZ")
    close(mt, JRo.euler_angles_to_matrix(jnp.asarray(e), "XYZ"), 2e-6)
    close(TRo.matrix_to_quaternion(mt),
          JRo.matrix_to_quaternion(jnp.asarray(mt.numpy())), 2e-6)
    close(TRo.matrix_to_axis_angle(mt),
          JRo.matrix_to_axis_angle(jnp.asarray(mt.numpy())), 2e-6)
    # Round trip: axis-angle -> matrix -> axis-angle.
    aa = rnd(5, 3, seed=4, scale=0.7)
    close(TRo.matrix_to_axis_angle(TL.exp_so3(t(aa))), aa, 2e-5)


def test_retriever():
    n = 4
    init = TL.make_c2w(t(rnd(n, 3, seed=5)), t(rnd(n, 3, seed=6)))
    pt, init_t = TRt.pose_retriever_init(n, init.numpy(), device="cpu")
    pj, init_j = JRt.pose_retriever_init(n, init.numpy())
    pt["r"] += t(rnd(n, 3, seed=7, scale=0.1))
    pt["t"] += t(rnd(n, 3, seed=8, scale=0.1))
    pj = {k: jnp.asarray(v.numpy()) for k, v in pt.items()}
    close(TRt.pose_retriever_all(pt, init_t),
          JRt.pose_retriever_all(pj, init_j), 2e-6)
    close(TRt.pose_retriever_apply(pt, init_t, 2),
          JRt.pose_retriever_apply(pj, init_j, 2), 2e-6)
    p0, i0 = TRt.pose_retriever_init(3, device="cpu")
    close(TRt.pose_retriever_all(p0, i0), np.broadcast_to(np.eye(4),
                                                          (3, 4, 4)), 0)


@pytest.fixture(scope="module")
def motion():
    jp = JF.motion_init(jax.random.PRNGKey(4), MOTION)
    net = X.params_from_jax(
        {"motion": jax.tree_util.tree_map(np.asarray, jp)},
        {"motion": TF.MotionConfig(**dataclasses.asdict(MOTION))},
        device="cpu")["motion"]
    return jp, net


def test_full_video_w2c(motion):
    jp, net = motion
    with torch.no_grad():
        got = TM.full_video_w2c(net, 9, 10)
    ref = JM.full_video_w2c(MOTION, jp, 9, 10)
    assert got.shape == (9, 4, 4)
    close(got, ref, 1e-5)
    close(got[0], np.eye(4), 0)


def test_relative_and_anchor(motion):
    jp, net = motion
    with torch.no_grad():
        w2c = TM.full_video_w2c(net, 7, 10)
    wj = jnp.asarray(w2c.numpy())
    close(TM.relative_pose(w2c, 1, 5), JM.relative_pose(wj, 1, 5), 2e-6)
    anch = TM.w2c_from_anchor(w2c, 3)
    close(anch, JM.w2c_from_anchor(wj, 3), 2e-6)
    close(anch[3], np.eye(4), 2e-6)
