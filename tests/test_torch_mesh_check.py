"""``chip_smoke.py``'s card-against-CPU mesh check (``mesh_agreement``) on the
CPU, with two ``Trainer`` stand-ins of one SDF network (the "card" one on the
CPU too): equal meshes pass; meshes whose grids differ by f32 rounding pass
within the bound; a vertex moved past its bound and a level that crosses
grid points fail. The check finds each vertex's edge by running the mesher
on the grid of signs alone; on both mesher paths that puts every vertex at
the middle of the edge the real grid puts it on, in the same order."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from copenerf_torch.mesher import marching_cubes as MC  # noqa: E402
from copenerf_torch.models.fields import SDFConfig, SDFNetwork  # noqa: E402
from copenerf_torch.models.mlp import perturb_  # noqa: E402
from copenerf_torch.training import trainer as TT  # noqa: E402

RES = 24


def _trainer(net, cls=TT.Trainer):
    """A Trainer with only what ``extract_geometry`` reads."""
    tr = cls.__new__(cls)
    tr.device = torch.device("cpu")
    tr.state = {"fields": {"sdf": net}}
    tr.world_time_step = 0.1
    return tr


@pytest.fixture(scope="module")
def net():
    cfg = SDFConfig(d_out=33, d_hidden=64, n_layers=4, skip_in=(2,), multires=3)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        return perturb_(SDFNetwork(cfg, g), g)


def test_mesh_agreement_equal_meshes(net):
    out = C.mesh_agreement(_trainer(net), _trainer(net), RES)
    assert out["ok"] and out["max_vertex_err_voxels"] == 0.0
    assert out["card_vertices"] > 100 and out["cpu_f64_err"] > 0


def test_mesh_agreement_f32_rounding_passes(net):
    """Weights moved by a few f32 ulps: the grids differ by about the plain
    f32 grid's own error against f64, and every vertex stays in its bound."""
    card = copy.deepcopy(net)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in card.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    out = C.mesh_agreement(_trainer(card), _trainer(net), RES)
    assert out["card_cpu_grid_diff"] > 0 and out["max_vertex_err_voxels"] > 0
    assert out["ok"] and out["worst_err_over_bound"] < 1


def test_mesh_agreement_moved_vertex_fails(net):
    class Moved(TT.Trainer):
        def extract_geometry(self, *args, **kwargs):
            v, t = super().extract_geometry(*args, **kwargs)
            v = v.copy()
            v[len(v) // 2, 0] += 2e-3 * 2.4 / (RES - 1)
            return v, t

    out = C.mesh_agreement(_trainer(net, Moved), _trainer(net), RES)
    assert out["same_signs_and_triangles"] and not out["ok"]
    assert out["worst_err_over_bound"] > 1


def test_mesh_agreement_shifted_level_fails(net):
    card = copy.deepcopy(net)
    with torch.no_grad():
        card.layers[f"lin{len(card.cfg.dims) - 2}"].b[0] += 0.05
    out = C.mesh_agreement(_trainer(card), _trainer(net), RES)
    assert not out["same_signs_and_triangles"] and not out["ok"]


@pytest.mark.parametrize("path", ["cpp", "numpy"])
def test_sign_grid_puts_vertices_at_edge_midpoints(path):
    march = MC.marching_cubes if path == "cpp" else MC._marching_tetrahedra_numpy
    rng = np.random.default_rng(0)
    x = np.linspace(-1, 1, 21)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    grid = (np.sin(3 * gx + rng.normal()) * np.cos(2 * gy)
            + 0.5 * np.sin(4 * gz) - 0.1).astype(np.float32)
    verts, tris = march(grid, 0.0)
    mid, mid_tris = march(np.where(grid < 0, -1.0, 1.0).astype(np.float32), 0.0)
    assert mid.shape == verts.shape and np.array_equal(mid_tris, tris)
    a, b = (f(mid).astype(np.int64) for f in (np.floor, np.ceil))
    assert np.all(np.abs(b - a).max(1) == 1)       # one edge of the mesher's
    fa, fb = (grid[tuple(p.T)].astype(np.float64) for p in (a, b))
    np.testing.assert_allclose(a + (fa / (fa - fb))[:, None] * (b - a), verts,
                               rtol=0, atol=1e-5)
