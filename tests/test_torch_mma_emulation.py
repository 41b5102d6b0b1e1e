"""The TF32 rounding of the tensor-core cores (``cvt.rna.tf32``,
``csrc/tf32_split.cuh``) and the weight-gradient reduction (``wgmma``,
``csrc/wgrad.cu``) as the host emulation runs them
(``copenerf_torch/ops/kernels/emulate.py``), through the check kernels of
``csrc/tc_check.cu`` on CPU tensors:

* ties: 1 + 2^-11 rounds away from zero to 1 + 2^-10 (ties-to-even would
  give 1), through the wgmma core's one-TF32-product control;
* 3xTF32 (the split the kernels ship) in the weight-gradient reduction
  against f64: within 2x the f32 FFMA reduction's error, and within 1e-6
  relative (staged rows padded with NaN, never read).

The tile GEMM of the row kernels is held against f64 in
``test_torch_wgmma_emulation.py``. Skips where there is no ``g++``."""

import shutil

import numpy as np
import pytest
import torch

from copenerf_torch.ops.kernels import emulate, pack
from copenerf_torch.ops.kernels import tc_check as TC


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the CUDA kernels needs g++")
    with emulate.emulated():
        yield


def tf32_np(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32)
    finite = (bits & 0x7F800000) != 0x7F800000
    bits = np.where(finite, (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000), bits)
    return bits.astype(np.uint32).view(np.float32)


def test_emulated_cvt_rounds_ties_away_from_zero(emu):
    tie = np.float32(1.0 + 2.0 ** -11)
    a = np.array([[tie, -tie, 1.0 + 2.0 ** -12, 3.0]] * 4, np.float32)
    got = TC.tile_gemm(torch.from_numpy(a), torch.eye(4), "wg_tf32").numpy()
    np.testing.assert_array_equal(
        got[0], [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0])
    np.testing.assert_array_equal(tf32_np(a), got)
    np.testing.assert_array_equal(pack.tf32_rna(torch.from_numpy(a)).numpy(), got)


@pytest.mark.parametrize("O,I", [(257, 52), (33, 64)])
def test_emulated_3xtf32_reduction_against_f64(emu, O, I):
    rng = np.random.default_rng(O * I)
    n = 1100
    z = np.full((n, (O + 3) // 4 * 4), np.nan, np.float32)
    t = np.full((n, (I + 3) // 4 * 4), np.nan, np.float32)
    z[:, :O] = rng.standard_normal((n, O))
    t[:, :I] = np.abs(rng.standard_normal((n, I)))
    ref = z[:, :O].T.astype(np.float64) @ t[:, :I]
    err = {}
    for m in ("ffma", "wg"):
        w_out, b_out = TC.row_reduce(torch.from_numpy(z), torch.from_numpy(t), O, I, m)
        err[m] = np.linalg.norm(w_out.numpy() - ref) / np.linalg.norm(ref)
        np.testing.assert_allclose(b_out.numpy(), z[:, :O].sum(0), rtol=0, atol=1e-4)
    assert err["wg"] <= min(2 * err["ffma"], 1e-6), err
