"""Camera-frustum trajectory visualization; a copy of
``copenerf_tpu/utils/frustum.py`` (numpy only).

Counterpart of the reference's ``utils_poses/vis_cam_traj.py`` (open3d
line-set frustums, optional). Here the frustum wireframes are built in plain
numpy and exported as an ASCII PLY line set — viewable in MeshLab/Blender —
with an optional open3d LineSet when that package is present.
"""

from __future__ import annotations

import numpy as np


def frustum_lines(c2ws: np.ndarray, fov_deg: float = 50.0,
                  frustum_length: float = 0.1):
    """Build frustum wireframes for (N, 4, 4) camera-to-world poses.

    Returns (points (N*5, 3), edges (N*8, 2)): per camera an apex + 4 image
    corners with 4 apex->corner edges and the 4 image-plane border edges.
    """
    half_w = frustum_length * np.tan(np.radians(fov_deg / 2.0))
    local = np.array([
        [0.0, 0.0, 0.0],
        [-half_w, -half_w, frustum_length],
        [half_w, -half_w, frustum_length],
        [half_w, half_w, frustum_length],
        [-half_w, half_w, frustum_length],
    ])
    edge_local = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                           [1, 2], [2, 3], [3, 4], [4, 1]])
    points, edges = [], []
    for i, c2w in enumerate(c2ws):
        world = local @ c2w[:3, :3].T + c2w[:3, 3]
        points.append(world)
        edges.append(edge_local + 5 * i)
    return np.concatenate(points, 0), np.concatenate(edges, 0)


def write_frustums_ply(path: str, c2ws: np.ndarray, color=(255, 0, 0),
                       **kwargs) -> None:
    """Write the frustum line set as ASCII PLY."""
    points, edges = frustum_lines(np.asarray(c2ws), **kwargs)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        r, g, b = color
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {r} {g} {b}\n")
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n")


def draw_camera_frustum_geometry(c2ws: np.ndarray, h: float = None,
                                 w: float = None, fx: float = None,
                                 fy: float = None,
                                 frustum_length: float = 0.1,
                                 color=(0.0, 1.0, 0.0)):
    """open3d LineSet (reference API shape); raises ImportError without
    open3d — callers guard like the reference does."""
    import open3d as o3d

    fov = 50.0
    if fx is not None and w is not None:
        fov = float(np.degrees(2 * np.arctan(w / (2 * fx))))
    points, edges = frustum_lines(np.asarray(c2ws), fov_deg=fov,
                                  frustum_length=frustum_length)
    ls = o3d.geometry.LineSet()
    ls.points = o3d.utility.Vector3dVector(points)
    ls.lines = o3d.utility.Vector2iVector(edges)
    ls.colors = o3d.utility.Vector3dVector(
        np.tile(np.asarray(color)[None], (len(edges), 1)))
    return ls
