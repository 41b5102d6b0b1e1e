"""Novel-view camera trajectory generation (render mode); a copy of
``copenerf_tpu/ops/trajectories.py`` (numpy and scipy only).

Numpy equivalents of the reference's path helpers in its
``model/common.py``: pose interpolation by slerp
(:489-500), b-spline translation interpolation (:501-509, :541-567), spiral
paths (:359-370, :569-593), spheric paths (:311-347), and NDC ray transform
(:612-655).
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def convert3x4_4x4(poses):
    poses = np.asarray(poses)
    if poses.ndim == 2:
        return np.concatenate(
            [poses, np.array([[0, 0, 0, 1]], poses.dtype)], 0)
    bottom = np.zeros_like(poses[:, :1])
    out = np.concatenate([poses, bottom], 1)
    out[:, 3, 3] = 1.0
    return out


def interp_poses(c2ws: np.ndarray, n_views: int) -> np.ndarray:
    """Slerp rotations + linear translations (reference :489-500)."""
    from scipy.spatial.transform import Rotation, Slerp

    n = len(c2ws)
    rots = Rotation.from_matrix(c2ws[:, :3, :3])
    slerp = Slerp(np.linspace(0, 1, n), rots)
    ts = np.linspace(0, 1, n_views)
    r_out = slerp(ts).as_matrix().astype(np.float32)
    # Translation interp matches torch.nn.functional.interpolate(
    # mode='linear', align_corners=False) used upstream: half-pixel centers,
    # clipped at the borders (NOT np.interp's endpoint-anchored grid).
    t_in = c2ws[:, :3, 3]
    x = (np.arange(n_views) + 0.5) * (n / n_views) - 0.5
    x = np.clip(x, 0.0, n - 1.0)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    frac = (x - lo)[:, None]
    t_out = (t_in[lo] * (1.0 - frac) + t_in[hi] * frac).astype(np.float32)
    return convert3x4_4x4(
        np.concatenate([r_out, t_out[:, :, None]], -1))


def bspline(control: np.ndarray, n: int = 100, degree: int = 3) -> np.ndarray:
    """Sample n points on an open b-spline through control vertices."""
    import scipy.interpolate as si

    count = len(control)
    degree = int(np.clip(degree, 1, count - 1))
    kv = np.clip(np.arange(count + degree + 1) - degree, 0, count - degree)
    spl = si.BSpline(kv, control, degree)
    return spl(np.linspace(0, count - degree, n))


def interp_poses_bspline(c2ws, n_novel: int, input_times, degree: int = 3):
    from scipy.spatial.transform import Rotation, Slerp

    t_out = bspline(c2ws[:, :3, 3], n=n_novel, degree=degree)
    rots = Rotation.from_matrix(c2ws[:, :3, :3])
    slerp = Slerp(np.asarray(input_times), rots)
    target_times = np.linspace(input_times[0], input_times[-1], n_novel)
    r_out = slerp(target_times).as_matrix()
    return convert3x4_4x4(np.concatenate(
        [r_out, t_out[:, :, None]], -1).astype(np.float32))


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def render_path_spiral(c2w, up, rads, focal, zrate, rots, n):
    poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([0.2 * np.cos(theta), -0.2 * np.sin(theta),
                             -np.sin(theta * zrate) * 0.1, 1.0]) * rads)
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return poses


def generate_spiral_path(learned_poses, bds, n_novel_views, hwf):
    """Spiral novel-view path around learned poses (reference :569-593)."""
    poses_ = np.concatenate(
        [learned_poses[:, :3, :4], hwf[:len(learned_poses)]], -1)
    c2w = poses_avg(poses_)
    up = _normalize(poses_[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = poses_[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    c2ws = render_path_spiral(c2w, up, rads, focal, zrate=0.5, rots=2,
                              n=n_novel_views)
    return np.stack(c2ws).astype(np.float32)[:, :3, :4]


def get_ndc_rays_fxfy(fxfy, near, rays_o, rays_d):
    """World rays -> NDC rays (reference :612-655)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -fxfy[0] * ox_oz
    o1 = -fxfy[1] * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -fxfy[0] * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -fxfy[1] * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return (np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1))


def create_spheric_poses(radius, mean_h, n_poses: int = 120):
    """Circular camera path around the z axis (reference :311-347)."""
    def spheric_pose(theta, phi, radius):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, 2 * mean_h],
                            [0, 0, 1, -radius]])
        rot_phi = np.array([[1, 0, 0], [0, np.cos(phi), -np.sin(phi)],
                            [0, np.sin(phi), np.cos(phi)]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta)], [0, 1, 0],
                              [np.sin(theta), 0, np.cos(theta)]])
        c2w = rot_theta @ rot_phi @ trans_t
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]]) @ c2w

    return np.stack([spheric_pose(th, -np.pi / 12, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]],
                    0)
