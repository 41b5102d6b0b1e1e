"""The port's mesher (``copenerf_torch/mesher``) against the JAX package's.

Both packages run the same marching tetrahedra: the port builds its own
copy of the C++ source with ``g++`` into ``copenerf_torch/_build/mesher/``
and never loads the JAX package's committed library. On the same grid the
two give bit-identical vertices and triangles, on the C++ path and on the
numpy fallback, so every comparison here is exact."""

import os
import struct

import numpy as np
import pytest

from copenerf_tpu.mesher import marching_cubes as JM
from copenerf_torch.mesher import marching_cubes as TM


def _sphere_grid(n, r=0.6):
    xs = np.linspace(-1, 1, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - r


def _random_grid(n=20, seed=0):
    """A random field with many crossings, smoothed along each axis so it
    also has larger patches of surface."""
    g = np.random.default_rng(seed).normal(size=(n, n, n))
    for axis in range(3):
        g = (g + np.roll(g, 1, axis)) / 2
    return g


GRIDS = {"sphere16": lambda: _sphere_grid(16), "sphere32": lambda: _sphere_grid(32),
         "random20": _random_grid}


def _assert_same(port, jax_side):
    (tv, tt), (jv, jt) = port, jax_side
    assert tv.dtype == jv.dtype and tt.dtype == jt.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_cpp_path_matches_jax_exactly(name):
    grid = GRIDS[name]()
    port = TM.marching_cubes(grid, 0.0)
    assert TM.last_path == "cpp"
    assert len(port[1]) > 100
    _assert_same(port, JM.marching_cubes(grid, 0.0))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_numpy_path_matches_jax_exactly(name):
    grid = np.ascontiguousarray(GRIDS[name](), np.float32)
    _assert_same(TM._marching_tetrahedra_numpy(grid, 0.0),
                 JM._marching_tetrahedra_numpy(grid, 0.0))


def test_numpy_fallback_when_the_library_is_missing(monkeypatch):
    grid = _sphere_grid(16)
    monkeypatch.setattr(TM, "_get_lib", lambda: None)
    port = TM.marching_cubes(grid, 0.0)
    assert TM.last_path == "numpy"
    _assert_same(port, JM._marching_tetrahedra_numpy(
        np.ascontiguousarray(grid, np.float32), 0.0))


def test_library_is_the_ports_own_build():
    lib = TM._get_lib()
    assert lib is not None, "the port's C++ mesher failed to build"
    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(TM.__file__))), "_build", "mesher")
    assert os.path.dirname(lib._name) == build_dir
    assert lib._name == TM.library_path()
    assert os.path.basename(lib._name) != "_marching.so"
    # Nothing is written beside the source.
    assert os.listdir(os.path.dirname(TM._CSRC)) == ["marching.cpp"]


def test_extract_geometry_matches_jax_exactly():
    def query(pts):
        return np.linalg.norm(pts * np.float32([1.0, 0.8, 1.3]), axis=-1) - 0.5

    bmin, bmax = [-1.0, -0.9, -1.1], [1.0, 1.2, 0.8]
    port = TM.extract_geometry(bmin, bmax, 40, 0.0, query, batch=4096)
    _assert_same(port, JM.extract_geometry(bmin, bmax, 40, 0.0, query))
    # The grid's axes are the coordinates of extract_geometry's points.
    axes = TM.grid_axes(bmin, bmax, 40)
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    grid = query(np.stack([gx, gy, gz], -1).reshape(-1, 3)).reshape(40, 40, 40)
    _assert_same(TM.mesh_grid(grid, bmin, bmax, 0.0), port)


def test_save_ply_is_little_endian(tmp_path):
    verts = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0, 7.0, 8.0]],
                     dtype=np.dtype(">f4"))
    tris = np.array([[0, 1, 2]], dtype=np.dtype(">i4"))
    path = str(tmp_path / "mesh.ply")
    TM.save_ply(path, verts, tris)
    with open(path, "rb") as f:
        blob = f.read()
    header_end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:header_end].decode("ascii")
    assert "format binary_little_endian 1.0" in header
    assert "element vertex 3" in header and "element face 1" in header
    body = blob[header_end:]
    assert struct.unpack("<9f", body[:36]) == tuple(range(9))
    assert struct.unpack("<B", body[36:37]) == (3,)
    assert struct.unpack("<3i", body[37:49]) == (0, 1, 2)
    # The same bytes as the JAX package's writer.
    JM.save_ply(str(tmp_path / "jax.ply"), verts, tris)
    assert open(tmp_path / "jax.ply", "rb").read() == blob
