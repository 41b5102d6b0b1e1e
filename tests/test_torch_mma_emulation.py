"""The tensor-core instructions of the render-core kernels (``cvt.rna.tf32``,
``mma.sync`` m16n8k8 TF32) as the host emulation runs them
(``copenerf_torch/ops/kernels/emulate.py``), through the check kernels of
``csrc/tc_check.cu`` on CPU tensors (the weight-gradient reduction, on
``wgmma``, beside them):

* one TF32 product (each operand rounded by ``cvt.rna``) against numpy's f64
  product of the same operands rounded to TF32 (nearest, ties away from
  zero, 10 explicit mantissa bits): within 4e-7 relative (the f32 sum);
* small integers, exact in TF32 and in every partial sum: the fragment
  layout must give the product exactly, at odd widths, in every ``mma.sync``
  mode of the tile GEMM;
* ties: 1 + 2^-11 rounds away from zero to 1 + 2^-10 (ties-to-even would
  give 1);
* 3xTF32 (the split the kernels ship) against f64: within 2x the f32 FFMA
  GEMM's error, and within 1e-6 relative, for the tile GEMM and the
  weight-gradient reduction (``wgmma``; staged rows padded with NaN, never
  read).

Skips where there is no ``g++``."""

import shutil

import numpy as np
import pytest
import torch

from copenerf_torch.ops.kernels import emulate
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


def _mats(m, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return a, w


@pytest.mark.parametrize("K,N", [(52, 256), (28, 64), (292, 36), (64, 28)])
def test_emulated_tf32_mma_matches_numpy(emu, K, N):
    a, w = _mats(70, K, N, seed=K + N)
    got = TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w), "tf32").numpy()
    ref = tf32_np(a).astype(np.float64) @ tf32_np(w).astype(np.float64)
    assert np.linalg.norm(got - ref) <= 4e-7 * np.linalg.norm(ref)


@pytest.mark.parametrize("K,N", [(52, 204), (28, 64), (292, 36)])
def test_emulated_mma_fragment_layout_is_exact(emu, K, N):
    """Every ``mma.sync`` path of the tile GEMM (K1's core): one TF32
    product, 3xTF32 as shipped and summed on the tensor core, and with the
    weights split on the host, at ragged K and N and a ragged row tile."""
    rng = np.random.default_rng(K * N)
    a = rng.integers(-8, 9, size=(70, K)).astype(np.float32)
    w = rng.integers(-8, 9, size=(K, N)).astype(np.float32)
    for mode in ("tf32", "3xtf32", "3xtf32_acc", TC.PRESPLIT):
        got = TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w), mode).numpy()
        np.testing.assert_array_equal(got, a.astype(np.float64) @ w, err_msg=mode)


def test_emulated_cvt_rounds_ties_away_from_zero(emu):
    tie = np.float32(1.0 + 2.0 ** -11)
    a = np.array([[tie, -tie, 1.0 + 2.0 ** -12, 3.0]] * 4, np.float32)
    got = TC.tile_gemm(torch.from_numpy(a), torch.eye(4), "tf32").numpy()
    np.testing.assert_array_equal(
        got[0], [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0])
    np.testing.assert_array_equal(tf32_np(a), got)
    np.testing.assert_array_equal(TC.tf32_rna(torch.from_numpy(a)).numpy(), got)


@pytest.mark.parametrize("K,N", [(52, 256), (256, 204), (292, 36), (28, 64)])
def test_emulated_3xtf32_split_against_f64(emu, K, N):
    a, w = _mats(130, K, N, seed=3 * K + N)
    a = np.abs(a)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    err = {m: np.linalg.norm(TC.tile_gemm(torch.from_numpy(a), torch.from_numpy(w),
                                          m).numpy() - ref) / np.linalg.norm(ref)
           for m in ("ffma", "3xtf32", "tf32")}
    assert err["3xtf32"] <= min(2 * err["ffma"], 1e-6), err
    assert err["tf32"] > 1e-5, err                  # the split is what buys it


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
