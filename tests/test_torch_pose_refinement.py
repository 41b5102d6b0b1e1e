"""Port parity for the stage-1 -> stage-2 pose refinement: the port's
``training/pose_refinement.py`` against the JAX package's on the CPU, on a
synthetic set of 6 views at 24x32 made with numpy from a seed (smooth
images whose pattern moves from view to view, smooth depths in [0.5, 3.5],
NDC intrinsics), 5 consecutive pairs.

Tolerances, f32 on both sides (the JAX side at HIGHEST matmul precision):
  * the warp terms and the batch loss: 1e-5 relative (the sums over the
    pixels of a pair run in another order);
  * the refinement: the poses 1e-4 absolute after 40 epochs (measured
    2.2e-5); the lr sequence and the epoch the convergence window stops
    at, exactly; the loss trace 1e-5 relative in epoch 0, where both
    packages evaluate the same poses (measured 4e-8), and TRACE_RTOL
    relative after it. The looser bound is forced by the loss's slope in
    the poses: the warp's bilinear cells and validity mask switch as the
    poses move, so the per-pair sums are piecewise smooth and their
    gradients cancel to a small part of their terms; the summation-order
    differences of those gradients move the poses apart by up to 2.2e-5,
    and that moves a loss of ~0.02 by up to 2.3e-4 relative (measured).
    The loss is a function of the poses; the poses are held to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copenerf_tpu.evaluation.metrics_pose import pose_error_report as j_report
from copenerf_tpu.models import fields as JF
from copenerf_tpu.training import pose_refinement as JR
from copenerf_torch.evaluation.metrics_pose import pose_error_report as t_report
from copenerf_torch.models import exchange as X
from copenerf_torch.models import fields as TF
from copenerf_torch.training import pose_refinement as TR

M, H, W = 6, 24, 32
LOSS_RTOL = 1e-5
TRACE_RTOL = 5e-4
POSE_ATOL = 1e-4


def scene(seed=0):
    """(images (M, 3, H, W), depths (M, H, W), k33 (M, 3, 3), gt c2w
    (M, 4, 4)), float32."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    freq = rng.uniform(0.1, 0.3, size=(3, 2))
    phase = rng.uniform(0, 2 * np.pi, size=3)
    images = np.stack([np.stack([
        0.5 + 0.4 * np.sin(freq[c, 0] * (xs + 0.8 * v) + freq[c, 1] * ys
                           + phase[c]) for c in range(3)]) for v in range(M)])
    depths = np.stack([2.0 + 1.2 * np.sin(0.15 * xs + 0.1 * ys + 0.3 * v)
                       * np.cos(0.05 * ys) for v in range(M)])
    fx = 30.0
    k = np.array([[2 * fx / W, 0, 0], [0, -2 * fx / H, 0], [0, 0, -1]])
    gt = np.tile(np.eye(4), (M, 1, 1))
    gt[:, 0, 3] = 0.05 * np.arange(M)
    gt[:, 2, 3] = 0.01 * np.arange(M) ** 2
    return (images.astype(np.float32), depths.astype(np.float32),
            np.tile(k, (M, 1, 1)).astype(np.float32), gt.astype(np.float32))


def rel_poses(seed, n, scale=0.05):
    """(n, 4, 4) rigid transforms near the identity."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3)).astype(np.float32) * scale
    t = rng.normal(size=(n, 3)).astype(np.float32) * scale
    return np.array(jax.vmap(JR.make_c2w)(jnp.asarray(r), jnp.asarray(t)))


class Recorder:
    """A logger that keeps every scalar."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def series(self, tag):
        return np.asarray([v for t, v, _ in self.rows if t.endswith(tag)])


def t(a):
    return torch.from_numpy(np.array(a))


def test_uv_grid_matches_jax():
    np.testing.assert_array_equal(TR._uv_grid(H, W),
                                  np.asarray(JR._uv_grid(H, W)))


def test_warp_terms_match_jax_with_invalid_points():
    """Both directions' per-pair sums, with pairs whose warp puts points
    behind the camera, exactly at z = 0 (a depth of 2 under a z shift of
    2: the guard's case) and outside the view."""
    images, depths, k33, _ = scene()
    depths[0, :4, :4] = 2.0
    rels = rel_poses(1, 3)
    rels[0, 2, 3] = 2.0                       # z of depth-2 points -> 0
    rels[1, 2, 3] = 3.0                       # most points behind
    rels[2, 0, 3] = 1.5                       # most pixels outside
    uv = JR._uv_grid(H, W)
    idx = np.arange(3)
    for a, b in ((idx, idx + 1), (idx + 1, idx)):
        ref = jax.vmap(lambda i, n, d, k, r: JR._warp_terms(i, n, d, k, uv, r))(
            images[a], images[b], depths[a], k33[a], rels)
        got = TR._warp_terms(t(images[a]), t(images[b]), t(depths[a]),
                             t(k33[a]), t(TR._uv_grid(H, W)), t(rels))
        for g, r in zip(got, ref):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=LOSS_RTOL, atol=1e-6)
    # The guard's pixels are invalid, and every case has some invalid ones.
    _, dens = TR._warp_terms(t(images[:3]), t(images[1:4]), t(depths[:3]),
                             t(k33[:3]), t(TR._uv_grid(H, W)), t(rels))
    assert (dens < H * W).all() and (dens[1:] < H * W / 2).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_batched_warp_loss_matches_jax(seed):
    """The batch loss in both directions: one ratio of batch-wide sums."""
    images, depths, k33, _ = scene(seed)
    rels = rel_poses(seed, M - 1)
    uv_j, uv_t = JR._uv_grid(H, W), t(TR._uv_grid(H, W))
    inv = np.asarray(jax.vmap(JR.se3_inverse)(jnp.asarray(rels)))
    for a, b, d, r in ((slice(0, -1), slice(1, None), slice(0, -1), rels),
                       (slice(1, None), slice(0, -1), slice(1, None), inv)):
        ref = JR.batched_warp_loss(images[a], images[b], depths[d],
                                   k33[:-1], uv_j, r)
        got = TR.batched_warp_loss(t(images[a]), t(images[b]), t(depths[d]),
                                   t(k33[:-1]), uv_t, t(r))
        np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)
        nums, dens = TR._warp_terms(t(images[a]), t(images[b]), t(depths[d]),
                                    t(k33[:-1]), uv_t, t(r))
        assert got.item() != pytest.approx(float((nums / dens).mean()),
                                           rel=1e-4)


def test_motion_init_relative_poses_matches_jax():
    """The motion field's consecutive-train-view relative poses, from
    exchanged weights, across a gap over a test frame."""
    cfg = JF.MotionConfig(d_hidden=32, n_layers=2, skip_in=(1,))
    params = {"motion": jax.device_get(JF.motion_init(jax.random.PRNGKey(4),
                                                     cfg))}
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, params)
    net = X.params_from_jax(params, {"motion": TF.MotionConfig(
        d_hidden=32, n_layers=2, skip_in=(1,))}, device="cpu")["motion"]
    i_train = [0, 1, 2, 4, 5, 6]
    ref = JR.motion_init_relative_poses(cfg, params["motion"], i_train, 7, 5)
    got = TR.motion_init_relative_poses(net, i_train, 7, 5)
    assert got.shape == (5, 4, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert np.abs(got.numpy() - np.eye(4)).max() > 1e-3


def _both(init_c2w=None, epochs=40, **kw):
    """(port, JAX) results and recorders of the same refinement."""
    images, depths, k33, gt = scene()
    out = []
    for mod, report in ((TR, t_report), (JR, j_report)):
        log = Recorder()
        extra = {"device": "cpu"} if mod is TR else {}
        poses = mod.run_pose_refinement(
            images, depths, k33, init_c2w=init_c2w, lr=1e-3, epochs=epochs,
            batch_size=4, logger=log, gt_poses=gt, pose_error_fn=report,
            **kw, **extra)
        out.append((poses, log))
    return out


@pytest.mark.parametrize("init", ["none", "motion"])
def test_run_pose_refinement_matches_jax(init):
    """40 epochs, batches of 4 and 1 pairs: the poses, the lr sequence
    (milestones at 30 and from there every 10), the loss trace and the pose
    metrics; the pairs outside a batch move through Adam's moments."""
    init_c2w = None if init == "none" else rel_poses(5, M - 1, scale=0.02)
    (got, glog), (ref, rlog) = _both(init_c2w)
    assert got.shape == (M, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(glog.series("/lr"), rlog.series("/lr"))
    assert glog.series("/lr")[30] == pytest.approx(1e-3 * 0.9)
    got_loss, ref_loss = glog.series("/_loss"), rlog.series("/_loss")
    assert len(got_loss) == len(ref_loss) == 40
    np.testing.assert_allclose(got_loss[0], ref_loss[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_loss, ref_loss, rtol=TRACE_RTOL)
    # The metrics of poses 1e-4 apart: ATE and RPE-trans (x100) to 1e-3
    # relative; RPE-rot in degrees to 2e-3 absolute, since it is the arccos
    # of (trace - 1) / 2 of f32 rotations near the identity, where one ulp
    # of the trace moves a 0.15 degree angle by ~3e-3 degrees.
    for tag in ("/ate", "/rpe_trans"):
        np.testing.assert_allclose(glog.series(tag), rlog.series(tag),
                                   rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(glog.series("/rpe_rot"),
                               rlog.series("/rpe_rot"), rtol=0, atol=2e-3)
    # Every pose moved away from its start.
    start = np.linalg.inv(np.asarray(JR.w2c_mappings(jnp.asarray(
        np.tile(np.eye(4, dtype=np.float32), (M - 1, 1, 1)) if init_c2w is None
        else init_c2w))))
    assert (np.abs(got - start).reshape(M, -1).max(1)[1:] > 1e-3).all()


def test_convergence_stops_at_the_same_epoch():
    """The 50-epoch window of epoch losses with std <= convergence_std
    stops both packages at the same epoch. The threshold lies between the
    window stds of the epochs before and at the stop, each more than 5%
    away from it, so rounding cannot move the stop. The window's std falls
    fastest while the steep first epochs leave it; 1e-4 lies there (the
    stds measured 1.12e-4 and 8.1e-5 at epochs 102 and 103), well past the
    first full window at epoch 49."""
    (_, glog), (_, rlog) = _both(epochs=200, convergence_std=1e-4)
    got, ref = glog.series("/_loss"), rlog.series("/_loss")
    assert 50 < len(got) == len(ref) < 200
    np.testing.assert_allclose(got, ref, rtol=TRACE_RTOL)
    assert np.std(ref[-50:]) <= 1e-4 * 0.95
    assert np.std(ref[-51:-1]) >= 1e-4 * 1.05


def test_zero_epochs_returns_none():
    images, depths, k33, _ = scene()
    assert TR.run_pose_refinement(images, depths, k33, epochs=0,
                                  device="cpu") is None
