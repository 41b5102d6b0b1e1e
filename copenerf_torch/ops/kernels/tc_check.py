"""The accuracy trial and card check of the tensor-core cores
(``csrc/tc_check.cu`` over ``csrc/wgmma_tile.cuh`` and ``csrc/wgrad.cu``):
the 64-row tile GEMM every row kernel (K1-K7) runs on ``wgmma`` in 3xTF32,
and the weight-gradient reduction every backward kernel runs on ``wgmma``,
on operands the caller chooses, beside f32 FFMA versions.

Nothing of the main path calls these launchers; ``tests/test_torch_gpu.py``,
``tests/test_torch_wgmma_emulation.py`` and
``tests/test_torch_mma_emulation.py`` (through the host emulation) and
``kernel_times.py --trial`` hold their results against an f64 product.
"""

from __future__ import annotations

import torch

from . import build
from .pack import wg_pack_b

# tile_gemm's `mode`: "ffma", the f32 FFMA control; and WG_MODES, the wgmma
# core (the weights packed by pack.wg_pack_b): "wg" as K1-fwd, K6-fwd, K2,
# K3, K4-fwd, K5-fwd and K7 ship it (a two-stage ring), one TF32 product,
# the control that shows what the split buys, and "wg_1stage" as K1-bwd,
# K6-bwd, K4-bwd and K5-bwd ship it (a one-stage ring).
WG_MODES = {"wg": 5, "wg_tf32": 6, "wg_1stage": 7}
MODES = {"ffma": 0, **WG_MODES}
# row_reduce's `mode`: the FFMA reduction (the trial's control), the wgmma
# one every backward kernel runs ("wg", 3xTF32) and its one-product control.
REDUCE_MODES = {"ffma": 0, "wg": 2, "wg_tf32": 1}
ROWS_PER_SPLIT = 1024        # wgrad.cu kRowsPerSplit


def _mat(t, name: str) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous f32 matrix")
    build.check_input(t, name, t.shape[1])


def tile_gemm(a: torch.Tensor, w: torch.Tensor, mode: str = "wg", reps: int = 1,
              aux: torch.Tensor | None = None) -> torch.Tensor:
    """a (m, K) @ w (K, N) through a tile GEMM (K and N multiples of 4,
    N <= 256): the FFMA control ("ffma") or the wgmma core in ``WG_MODES``
    (w packed here). For
    timing: each block repeats the GEMM ``reps`` times, and with ``aux``
    (2 m N floats) the epilogue multiplies by aux[i] and stores to
    aux[m N + i], the load-after-store chain of the sweeps' epilogues."""
    _mat(a, "a")
    _mat(w, "w")
    if w.shape[0] != a.shape[1]:
        raise ValueError(f"a is {tuple(a.shape)}, w {tuple(w.shape)}")
    c = torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    n_out = w.shape[1]
    if mode in WG_MODES:
        w = wg_pack_b(w.t())
    code = build.load_library().copenerf_tile_gemm_check(
        a.data_ptr(), w.data_ptr(), c.data_ptr(), a.shape[0],
        a.shape[1], n_out, MODES[mode], reps,
        aux.data_ptr() if aux is not None else None, build.stream(a))
    build.check(code, f"tile_gemm_check {mode}")
    return c


def row_reduce(z, t: torch.Tensor, O: int, I: int, mode: str = "wg",
               rows: int = 0, pair2=None):
    """(sum over pairs of z[:, :O]^T t[:, :I] (O, I), z[:, :O].sum(0) of the
    first pair) through the weight-gradient reduction in ``REDUCE_MODES``,
    z and t staged as the backward kernels stage them: row strides
    z.shape[1], t.shape[1] (multiples of 4, at least O and I); the columns
    past O and I are never read. z None: ones (stride O rounded up to 4);
    ``rows``: the pair stops at that row (0: all); ``pair2`` = (z2, t2,
    rows2): a second pair of the same shapes, as the render-core backward
    adds the gradient sweep's rows to a hidden layer's."""
    _mat(t, "t")
    if z is not None:
        _mat(z, "z")
    n, ldz = t.shape[0], z.shape[1] if z is not None else -(-O // 4) * 4
    z2, t2, rows2 = pair2 if pair2 is not None else (None, None, 0)
    for m, name, ld in ((z2, "z2", ldz), (t2, "t2", t.shape[1])):
        if m is not None:
            _mat(m, name)
            if m.shape != (n, ld):
                raise ValueError(f"{name} is {tuple(m.shape)}, expected {(n, ld)}")
    f32 = dict(dtype=torch.float32, device=t.device)
    w_out = torch.empty((O, I), **f32)
    b_out = torch.empty((O,), **f32)
    partial = torch.empty((O * I + O) * -(-n // ROWS_PER_SPLIT), **f32)

    def ptr(m):
        return m.data_ptr() if m is not None else None

    code = build.load_library().copenerf_wgrad_check(
        ptr(z), t.data_ptr(), rows, ptr(z2), ptr(t2), rows2,
        2 if pair2 is not None else 1, w_out.data_ptr(), b_out.data_ptr(),
        partial.data_ptr(), n, O, I, ldz, t.shape[1], REDUCE_MODES[mode],
        build.stream(t))
    build.check(code, f"wgrad_check {mode}")
    return w_out, b_out


def rel_err(got: torch.Tensor, ref64: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| against an f64 reference."""
    return ((got.double() - ref64).norm() / ref64.norm()).item()
