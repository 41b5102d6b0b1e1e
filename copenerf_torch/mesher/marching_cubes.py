"""Isosurface extraction (port of ``copenerf_tpu/mesher/marching_cubes.py``):
native C++ marching tetrahedra with a lazy build, plus a pure-numpy
fallback.

Replaces the reference's ``mcubes.marching_cubes`` call (the reference's
``model/neus_renderer.py:28-36``): same contract — ``marching_cubes(grid,
threshold) -> (vertices in grid coords, triangles)``. Triangulation differs
(tetrahedral decomposition) but the extracted surface is the same iso level.

``marching_cubes``, ``_marching_tetrahedra_numpy``, ``extract_geometry`` and
``save_ply`` are the JAX package's, so on the same grid both packages give
bit-identical vertices and triangles. The port keeps its own copy of the
C++ source (``csrc/marching.cpp``) and never loads the JAX package's
library: ``g++`` builds it at first use into ``copenerf_torch/_build/mesher/``
(gitignored), keyed by a hash of the source and the flags, with the
compiler's output in a log file beside the library. Where the build or the
load fails, the numpy fallback runs; ``last_path`` says which path the last
``marching_cubes`` call took (``"cpp"`` or ``"numpy"``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "marching.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "mesher")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

# The path the last marching_cubes call took: "cpp" or "numpy".
last_path = None


class _MeshResult(ctypes.Structure):
    _fields_ = [("n_verts", ctypes.c_int64), ("n_tris", ctypes.c_int64),
                ("verts", ctypes.POINTER(ctypes.c_float)),
                ("tris", ctypes.POINTER(ctypes.c_int64))]


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_CSRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmarching_{h.hexdigest()[:16]}.so")


def _build_library() -> str | None:
    """Build the library unless it is there; its path, or None where g++
    fails (its output is in the ``.log`` beside the library)."""
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        with open(os.path.splitext(lib)[0] + ".log", "w") as log:
            subprocess.check_call(["g++", *GXX_FLAGS, _CSRC, "-o", tmp],
                                  stdout=log, stderr=subprocess.STDOUT)
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _get_lib():
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.extract_isosurface.restype = ctypes.POINTER(_MeshResult)
    lib.extract_isosurface.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.free_mesh.argtypes = [ctypes.POINTER(_MeshResult)]
    return lib


def marching_cubes(grid: np.ndarray, threshold: float, n_threads: int = 0):
    """(nx, ny, nz) scalar field -> (vertices (V, 3) float in grid index
    coords, triangles (T, 3) int64). Surface at ``grid == threshold``."""
    global last_path
    grid = np.ascontiguousarray(grid, np.float32)
    lib = _get_lib()
    if lib is not None:
        last_path = "cpp"
        ptr = lib.extract_isosurface(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            grid.shape[0], grid.shape[1], grid.shape[2],
            ctypes.c_float(threshold), n_threads)
        res = ptr.contents
        nv, nt = int(res.n_verts), int(res.n_tris)
        verts = np.ctypeslib.as_array(res.verts, (nv, 3)).copy() if nv else \
            np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(res.tris, (nt, 3)).copy() if nt else \
            np.zeros((0, 3), np.int64)
        lib.free_mesh(ptr)
        return verts, tris
    last_path = "numpy"
    return _marching_tetrahedra_numpy(grid, threshold)


# Tetrahedral decomposition sharing the 0-7 cube diagonal (corner c offsets:
# ((c>>0)&1, (c>>1)&1, (c>>2)&1)); kept in sync with csrc/marching.cpp.
_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _marching_tetrahedra_numpy(grid: np.ndarray, iso: float):
    """Vectorized numpy fallback (same algorithm as the C++ kernel)."""
    nx, ny, nz = grid.shape
    xs, ys, zs = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    corner_off = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                           for c in range(8)])
    node_ids = ((base[:, None, 0] + corner_off[None, :, 0]) * ny * nz +
                (base[:, None, 1] + corner_off[None, :, 1]) * nz +
                (base[:, None, 2] + corner_off[None, :, 2]))   # (C, 8)
    vals = grid.reshape(-1)[node_ids]
    active = ((vals < iso).any(1)) & ((vals >= iso).any(1))
    node_ids = node_ids[active]
    vals = vals[active]

    tri_edges = []  # list of (3, 2) edge endpoint id arrays + t
    for tet in _TETS:
        tn = node_ids[:, tet]            # (C, 4)
        tv = vals[:, tet]
        inside = tv < iso
        n_in = inside.sum(1)
        for count, quad in ((1, False), (3, False), (2, True)):
            sel = n_in == count
            if not sel.any():
                continue
            sn, sv, si = tn[sel], tv[sel], inside[sel]
            ea, eb, et = [], [], []
            for (i, j) in _TET_EDGES:
                cross = si[:, i] != si[:, j]
                a, b = sn[:, i], sn[:, j]
                va, vb = sv[:, i], sv[:, j]
                t = np.where(vb != va, (iso - va) / np.where(vb != va,
                                                             vb - va, 1.0),
                             0.5)
                swap = a > b
                a2 = np.where(swap, b, a)
                b2 = np.where(swap, a, b)
                t2 = np.where(swap, 1.0 - t, t)
                ea.append(np.where(cross, a2, -1))
                eb.append(np.where(cross, b2, -1))
                et.append(np.where(cross, t2, 0.0))
            ea = np.stack(ea, 1)
            eb = np.stack(eb, 1)
            et = np.stack(et, 1)
            # Compact crossing edges per row (3 or 4 crossings).
            order = np.argsort(ea == -1, axis=1, kind="stable")
            ea = np.take_along_axis(ea, order, 1)
            eb = np.take_along_axis(eb, order, 1)
            et = np.take_along_axis(et, order, 1)
            if not quad:
                tri_edges.append((ea[:, :3], eb[:, :3], et[:, :3]))
            else:
                idx1 = [0, 1, 2]
                idx2 = [2, 1, 3]
                tri_edges.append((ea[:, idx1], eb[:, idx1], et[:, idx1]))
                tri_edges.append((ea[:, idx2], eb[:, idx2], et[:, idx2]))

    if not tri_edges:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    ea = np.concatenate([x[0] for x in tri_edges]).reshape(-1)
    eb = np.concatenate([x[1] for x in tri_edges]).reshape(-1)
    et = np.concatenate([x[2] for x in tri_edges]).reshape(-1)
    keys = ea * (nx * ny * nz) + eb
    uniq, inv = np.unique(keys, return_inverse=True)
    first = np.zeros(len(uniq), np.int64)
    first[inv[::-1]] = np.arange(len(keys) - 1, -1, -1)

    def decode(ids):
        z = ids % nz
        y = (ids // nz) % ny
        x = ids // (nz * ny)
        return np.stack([x, y, z], -1).astype(np.float32)

    pa = decode(ea[first])
    pb = decode(eb[first])
    verts = pa + et[first][:, None] * (pb - pa)
    tris = inv.reshape(-1, 3).astype(np.int64)
    return verts.astype(np.float32), tris


def grid_axes(bound_min, bound_max, resolution: int):
    """The grid's three f32 axes: the coordinates ``extract_geometry``'s
    points take (``np.linspace`` cast to f32)."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    return [np.linspace(bound_min[d], bound_max[d], resolution)
            .astype(np.float32) for d in range(3)]


def mesh_grid(grid: np.ndarray, bound_min, bound_max, threshold: float):
    """The ``threshold`` level set of a (res, res, res) grid sampled on
    ``grid_axes(bound_min, bound_max, res)``, in world coordinates."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    resolution = grid.shape[0]
    verts, tris = marching_cubes(grid, threshold)
    verts = verts / (resolution - 1.0) * (bound_max - bound_min)[None] + \
        bound_min[None]
    return verts.astype(np.float32), tris


def extract_geometry(bound_min, bound_max, resolution: int, threshold: float,
                     query_fn, batch: int = 64 ** 3):
    """Reference ``extract_geometry`` contract (neus_renderer.py:10-36):
    evaluate ``query_fn(pts (N, 3)) -> (N,)`` over a resolution^3 grid and
    extract the ``threshold`` level set in world coordinates."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    xs = np.linspace(bound_min[0], bound_max[0], resolution)
    ys = np.linspace(bound_min[1], bound_max[1], resolution)
    zs = np.linspace(bound_min[2], bound_max[2], resolution)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    vals = np.concatenate([np.asarray(query_fn(pts[i:i + batch])).reshape(-1)
                           for i in range(0, len(pts), batch)])
    grid = vals.reshape(resolution, resolution, resolution)
    return mesh_grid(grid, bound_min, bound_max, threshold)


def save_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Write a binary little-endian PLY (the format mcubes users export to).

    Dtypes are forced little-endian explicitly so the declared format holds
    on big-endian hosts too."""
    verts = np.ascontiguousarray(verts, np.dtype("<f4"))
    tris = np.ascontiguousarray(tris, np.dtype("<i4"))
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(tris)}\n"
        "property list uchar int vertex_indices\nend_header\n")
    face_rec = np.empty(
        len(tris),
        dtype=np.dtype([("n", np.dtype("<u1")), ("idx", np.dtype("<i4"), (3,))]))
    face_rec["n"] = 3
    face_rec["idx"] = tris
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.tobytes())
        f.write(face_rec.tobytes())
