// The render-core forward row kernel, shared by K1-fwd (rendercore_fwd.cu)
// and K6-fwd (rendercore_cons_fwd.cu): one template, one instantiation in
// each, so the two build in parallel.
//
// K1-fwd — the render-core field query, forward only — and K6-fwd — the
// same with the sdf-consistency query folded in.
//
// Replaces: copenerf_tpu/ops/pallas/rendercore_kernels.py `_build` ->
// `fwd_kernel` (launched by `call_fwd`):
//   * K1-fwd (with_cons=False, exposed through `get_fused_rendercore`): one
//     launch per render chunk, 128 samples per ray;
//   * K6-fwd (with_cons=True, exposed through `get_fused_rendercore_cons`,
//     the JAX package's COPENERF_FOLD_CONS=1): one launch per train step
//     (131,072 rows); after each x tile the same block runs K2's value sweep
//     on the matching tile of y, the world-transformed samples, and writes
//     sdf_w = (h . W_last[:, 0] + b) / scale.
//
// Computes, per row (x (4), unit view dir (3)):
//   SDF forward: PE(x * scale) -> hidden layers (softplus-100, skip / sqrt(2))
//     -> sdf = (h . W_last[:, 0] + b) / scale and feature = h @ W_last[:, 1:];
//   input gradient, reverse sweep (sdf_kernels.py `_grad_sweep_tile`):
//     r = W_last[:, 0]; per hidden layer q = r * sigmoid(100 z), r = q @ W^T,
//     split at the skip (h | e) / sqrt(2); then grad = J_pe^T ee;
//   IDR color: MLP on [x, PE(dirs), grad, feature] (ReLU), sigmoid head.
// Outputs sdf (n, 1), grad (n, 4), color (n, 3).
//
// Bound on an H100: operations. ~2.5 MFLOP against ~60 bytes per row; the
// f32 FFMA rate (67 TFLOP/s) is the limit by more than 1000x. On the tensor
// cores in 3xTF32 (tf32_split.cuh: each f32 product as three TF32 products,
// f32-level accuracy) the roof is 3 x FLOP / 495 TFLOP/s, 0.41x the FFMA
// bound (`tc_bound_ms` in chip_smoke.py).
// Design:
//  * Every GEMM of the SDF forward, the feature, the gradient sweep and the
//    color MLP runs on wgmma_tile.cuh's 3xTF32 `wgmma` core with the
//    two-stage ring (the policy G = WgGemm, as K4-fwd and K5-fwd): a
//    warpgroup owns 128 output columns of all 64 rows, issues a slice's
//    products and waits once; the weights, packed by the host as wgmma B
//    (pack.py `pack_rendercore_layers`), come from shared memory through
//    the descriptor, one 1-D bulk copy a 32-deep slice completing on an
//    mbarrier, the next slice's copy in flight behind the current
//    slice's products. The narrow heads (the SDF column 0, the 3 colors)
//    stay FFMA row dots on the plain columns.
//  * The 256-wide feature waits out the gradient sweep in the block's
//    scratch (64 KB a tile, written once and read back once, mostly from
//    L2) and is copied into the color input once the sweep is done, so one
//    row buffer serves in turn the activations (64 x 272: the stride of 272
//    floats, 16 mod 32 banks, keeps the A-fragment loads free of bank
//    conflicts) and the color input (64 x 292: feature, x, PE(dirs), grad,
//    pad; 16-byte rows), which color layer 0 overwrites with its output as
//    K5-fwd does. Beside it: the PE / skip-gradient buffer and the
//    two-stage ring (2 x 64 KB, alignment slack and barriers): 224,320 of
//    the 232,448 bytes a block may use at the default config, so one block
//    (8 warps) per SM. Keeping the feature in shared memory, as the TPU
//    kernel keeps it on chip, takes a second row buffer and leaves room for
//    one stage only (228,416 bytes), which exposed each slice's copy: 303
//    ms a render chunk against 254 (PERF.md §6).
//  * The sweep needs the 8 hidden layers' sigmoid(100 z): 8 KB per row, 512
//    KB per 64-row tile, far beyond 227 KB of shared memory. They go to a
//    per-block scratch in device memory (written once, read once: 16 KB a
//    row, ~2.1 GB at 131,072 rows, ~0.6 ms at the HBM rate where it misses
//    L2), sized by a persistent grid of one block per SM (about 78 MB on 132
//    SMs with the feature, so a large part stays in the 50 MB L2) and never
//    by n.
//  * The color input columns are permuted on the host (feature first) so the
//    feature lands in columns 0..255 and the small parts follow.
//  * The sweeps are mlp_tile.cuh's, shared with K4-fwd (sdf_outgrad_fwd.cu)
//    and K5-fwd (color_fwd.cu), which run them on the same core.
//  * K6-fwd (kCons) reuses the x tile's buffers (h, e, xs) for the y tile
//    once the x tile's outputs are written: ~0.92 MFLOP a row more against
//    20 bytes (y in, sdf_w out), on the same core.
#pragma once

#include "wgmma_tile.cuh"

namespace copenerf {
namespace {

using G = WgGemm;

template <bool kCons>
__global__ void __launch_bounds__(kThreads, 1)
rendercore_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                      const float* __restrict__ y, float* __restrict__ sdf_out,
                      float* __restrict__ grad_out, float* __restrict__ color_out,
                      float* __restrict__ sdfw_out, const float* __restrict__ P,
                      Offsets off, float* __restrict__ scratch, long long n,
                      SdfGeom g, ColorGeom cg) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // activations, row stride kTcLd;
  float* cin = h;                              //   the color input, stride cg.k0
  float* e = h + kRows * max(cg.k0, kTcLd);    // PE, then the skip part of the sweep
  float* xs = e + kRows * g.d0;                // x * scale
  float* xr = xs + kRows * 4;           // raw x
  float* dr = xr + kRows * 4;           // dirs (3 used)
  float* gs = dr + kRows * 4;           // grad
  float* w_s = gs + kRows * 4;
  const int n_hidden = g.n_lin - 1;
  float* sig_s = scratch + (long long)blockIdx.x * (n_hidden + 1) * kRows * 256;
  float* feat_s = sig_s + (long long)n_hidden * kRows * 256;  // the feature
  const long long tiles = (n + kRows - 1) / kRows;
  auto sig_at = [&](int l, int r, int c) { return sig_s[((long long)l * kRows + r) * 256 + c]; };
  auto none = [](int, int, int, float) {};

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      const bool ok = gr < n;
      xr[i] = ok ? x[gr * 4 + j] : 0.0f;
      dr[i] = (ok && j < 3) ? dirs[gr * 3 + j] : 0.0f;
    }
    load_and_encode(x, n, row0, g, xs, e);

    // ---- SDF forward; sigmoids to the block's scratch ----
    sdf_hidden_forward<G::kSliceK, G>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) {
          sig_s[((long long)l * kRows + r) * 256 + c] = sig;
        },
        none);
    __syncthreads();
    const float b0 = P[off.b_last0];
    rowdot(h, kTcLd, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
      const long long gr = row0 + r;
      if (gr < n) sdf_out[gr] = (v + b0) / g.scale;
    });
    {
      const float* bf = P + off.b_feat;
      G::run<G::kSliceK>(h, kTcLd, g.hidden, G::wf(P, off), cg.d_feat, cg.d_feat, w_s,
                         [&](int r, int c, float z) { feat_s[r * 256 + c] = z + bf[c]; });
    }

    // ---- input-gradient sweep in h: q = W_last[:, 0] * sig, r = q @ W^T ----
    sdf_grad_sweep<G::kSliceK, G>(P, off, g, h, e, w_s, 0, sig_at, none);
    // h now holds ee (d0 wide): grad = J_pe^T ee.
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const float acc = pe4_jac_t(h + r * kTcLd, xs + r * 4, g.multires, j);
      gs[i] = acc;
      const long long gr = row0 + r;
      if (gr < n) grad_out[gr * 4 + j] = acc;
    }
    __syncthreads();  // every read of ee in h is done: h becomes the color input
    for (int i = threadIdx.x; i < kRows * cg.d_feat; i += kThreads) {
      const int r = i / cg.d_feat, c = i - r * cg.d_feat;
      cin[r * cg.k0 + c] = feat_s[r * 256 + c];
    }

    // ---- color MLP on [feature, x, PE(dirs), grad, 0] ----
    color_forward<G::kSliceK, false, G>(P, off, cg, cin, h, w_s, xr, dr, gs, none,
                                        [&](int r, int c, float v) {
                                          const long long gr = row0 + r;
                                          if (gr < n) color_out[gr * 3 + c] = v;
                                        });

    if constexpr (kCons) {
      // ---- the consistency query: K2's value sweep on the tile of y ----
      __syncthreads();  // the x tile's readers of xs and e are done
      load_and_encode(y, n, row0, g, xs, e);
      sdf_hidden_forward<G::kSliceK, G>(P, off, g, e, h, w_s, none, none);
      __syncthreads();
      rowdot(h, kTcLd, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
        const long long gr = row0 + r;
        if (gr < n) sdfw_out[gr] = (v + b0) / g.scale;
      });
    }
  }
}

// Shared memory of one block, in bytes: 224,320 at the default config
// (d0 52, k0 292).
size_t rendercore_smem(int d0, int k0) {
  return sizeof(float) * (kRows * (k0 > kTcLd ? k0 : kTcLd) + kRows * d0 + 4 * kRows * 4 +
                          G::kWsFloats);
}

template <bool kCons>
int rendercore_fwd_run(const float* x, const float* dirs, const float* y, float* sdf,
                       float* grad, float* color, float* sdf_w, const float* params,
                       const long long* off_b, const long long* off_wp,
                       const long long* off_wtp, long long off_w_last0, long long off_b_last0,
                       long long off_wfp, long long off_b_feat, const long long* off_wcp,
                       const long long* off_bc, long long off_wc_last, float* scratch,
                       long long n, int n_lin, int d_in, int multires, int hidden, int skip,
                       float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires,
                       int c_k0, int squeeze, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  if (d_in != 4 || c_k0 % 4) return (int)cudaErrorInvalidValue;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  ColorGeom cg{c_n_lin, c_hidden, c_multires, d_feat, c_k0, squeeze};
  Offsets off;
  if (!make_rendercore_offsets(off, n_lin - 1, off_b, off_wp, off_wtp, off_w_last0,
                               off_b_last0, off_wfp, 0, off_b_feat, c_n_lin, off_wcp, nullptr,
                               0, off_bc, off_wc_last, 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rendercore_smem(g.d0, cg.k0);
  cudaError_t err = cudaFuncSetAttribute(
      rendercore_fwd_kernel<kCons>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  rendercore_fwd_kernel<kCons><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, dirs, y, sdf, grad, color, sdf_w, params, off, scratch, n, g, cg);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace copenerf
