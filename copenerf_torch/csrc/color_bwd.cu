// K5-bwd — the IDR color MLP's first-order backward.
//
// Replaces: copenerf_tpu/ops/pallas/color_kernels.py `_build` -> `bwd_kernel`
// (launched by `call_bwd`, the backward of `get_fused_color`). One launch per
// train step of a config with the negative ray vector (131,072 rows).
//
// Computes, per row, for the cotangent cbar (3) of K5-fwd's color
// (color_fwd.cu): the forward recomputed (each layer's input staged), zbar =
// cbar * c (1 - c) down the ReLU layers to h0_bar, the cotangent of
// [x, PE(dirs), grad, feature], and from it x_bar (4), dirs_bar =
// J_pe(dirs)^T PE_bar (3), grad_bar (4) and feat_bar (d_feat). Nothing is
// severed: the reference lets the color loss reach the points, the view
// directions (pose optimization) and the SDF gradient (whose own backward,
// K4-bwd, carries it on as its gbar). Weight gradients (wgrad.cu, from the
// staged rows): layer l sum zbar_l^T in_l, b sum zbar_l.
//
// Bound on an H100: operations. ~1.6 MFLOP per row at the default config
// (forward 0.54, backward 0.54, weight reductions 0.55) against 1,080 bytes
// in and 1,068 out (feature row and its cotangent).
// Design: the color part of K1-bwd (rendercore_bwd.cu) through the same
// color_forward and color_backward (mlp_tile.cuh), every hidden layer's GEMM
// both ways on the wgmma 3xTF32 core (wgmma_tile.cuh) with a one-stage ring
// (WgGemm1): the activations (64 x 272) and the color input, which ends
// holding h0_bar (64 x 292), stay apart, so two stages would need 280,640
// bytes of the 232,448 a block may have; one takes 215,104 (the input's
// stride stays 292: 304 measured equal, color_fwd.cu). h0_bar (N = 292) is
// two passes, 256 columns and 36, each with its own packed B (pack.py
// `pack_color`). The 3-wide head stays FFMA (a per-row dot forward, a
// 3-term loop backward, on the plain W): as a wgmma B it would be padded to
// N = 128, 42x its work. 64-row tiles, one block per tile; the layer inputs
// and output cotangents (~8 KB a row) are staged per row in device memory
// and reduced on the tensor cores in 3xTF32 by wgrad.cu's deterministic
// split-row GEMM on `wgmma` (`wgrad_tc_launch`, as K1, K3, K4 and K7; the
// strides rounded to 4 floats, the head's O = 3 and layer 0's I = 292
// zero-filled past their widths).
#include "wgmma_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

using G = WgGemm1;

// Staged per-row matrices of K5-bwd.
struct ClStages {
  StageSet ci;  // color layer inputs (layer 0 in the kernel's column order)
  StageSet cz;  // color layer output cotangents zbar_l
};

__global__ void __launch_bounds__(kThreads, 1)
color_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                 const float* __restrict__ grad, const float* __restrict__ feat, long long ld_feat,
                 const float* __restrict__ cbar, float* __restrict__ xbar,
                 float* __restrict__ dbar, float* __restrict__ gbar, float* __restrict__ fbar,
                 const float* __restrict__ P, Offsets off, long long n, ColorGeom cg,
                 ClStages st) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // activations / zbar, row stride kLd
  float* cin = h + kRows * G::kLd;             // color input, then h0_bar, stride cg.k0
  float* xr = cin + kRows * cg.k0;             // x
  float* dr = xr + kRows * 4;                  // dirs (3 used)
  float* gs = dr + kRows * 4;                  // grad
  float* cs = gs + kRows * 4;                  // color, then zbar of the head
  float* w_s = cs + kRows * 4;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int o_x = cg.d_feat;  // kernel color-input columns
  const int o_d = o_x + 4;
  const int o_g = o_d + 3 * (1 + 2 * cg.multires);

  for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
    const int r = i >> 2, j = i & 3;
    const long long gr = row0 + r;
    const bool ok = gr < n;
    xr[i] = ok ? x[gr * 4 + j] : 0.0f;
    dr[i] = (ok && j < 3) ? dirs[gr * 3 + j] : 0.0f;
    gs[i] = ok ? grad[gr * 4 + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * cg.d_feat; i += kThreads) {
    const int r = i / cg.d_feat, c = i - r * cg.d_feat;
    const long long gr = row0 + r;
    cin[r * cg.k0 + c] = gr < n ? feat[gr * ld_feat + c] : 0.0f;
  }
  __syncthreads();

  // ---- forward, every layer's input staged ----
  color_forward<G::kSliceK, true, G>(
      P, off, cg, cin, h, w_s, xr, dr, gs,
      [&](int l, int r, int c, float v) { stage_put(st.ci, l, row0 + r, n, c, v); },
      [&](int r, int c, float v) { cs[r * 4 + c] = v; });
  __syncthreads();

  // ---- backward: h0_bar into cin ----
  color_backward<G::kSliceK, G>(
      P, off, cg, cin, h, cs, w_s,
      [&](int r, int j) {
        const long long gr = row0 + r;
        return gr < n ? cbar[gr * 3 + j] : 0.0f;
      },
      [&](int l, int r, int c) { return stage_get(st.ci, l, row0 + r, n, c); },
      [&](int l, int r, int c, float v) { stage_put(st.cz, l, row0 + r, n, c, v); });
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
    const int r = i >> 2, j = i & 3;
    const long long gr = row0 + r;
    if (gr >= n) continue;
    xbar[gr * 4 + j] = cin[r * cg.k0 + o_x + j];
    gbar[gr * 4 + j] = cin[r * cg.k0 + o_g + j];
    if (j < 3) dbar[gr * 3 + j] = pe3_jac_t(cin + r * cg.k0 + o_d, dr + r * 4, cg.multires, j);
  }
  for (int i = threadIdx.x; i < kRows * cg.d_feat; i += kThreads) {
    const int r = i / cg.d_feat, c = i - r * cg.d_feat;
    const long long gr = row0 + r;
    if (gr < n) fbar[gr * cg.d_feat + c] = cin[r * cg.k0 + c];
  }
}

// The staged matrices of ClStages; with base null only the size is
// counted. Returns the floats used.
long long cl_stage_layout(const ColorGeom& cg, long long n, float* base, ClStages& st) {
  long long used = 0;
  auto take = [&](StageSet& s, int l, int width) {
    const int ld = (width + 3) & ~3;
    s.p[l] = base ? base + used : nullptr;
    s.ld[l] = ld;
    used += n * ld;
  };
  for (int l = 0; l < cg.n_lin; ++l) {
    take(st.ci, l, l == 0 ? cg.k0 : cg.hidden);
    take(st.cz, l, l == cg.n_lin - 1 ? 3 : cg.hidden);
  }
  return used;
}

int cl_jobs(const ColorGeom& cg, const ClStages& st, float* grads, const long long* off_gwc,
            const long long* off_gbc, WgradJob* jobs) {
  for (int l = 0; l < cg.n_lin; ++l) {
    WgradJob& j = jobs[l];
    j.O = l == cg.n_lin - 1 ? 3 : cg.hidden;
    j.I = l == 0 ? cg.k0 : cg.hidden;
    j.n_pairs = 1;
    j.p[0] = WgradPair{st.cz.p[l], st.ci.p[l], st.cz.ld[l], st.ci.ld[l]};
    j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
    j.w_out = grads ? grads + off_gwc[l] : nullptr;
    j.b_out = grads ? grads + off_gbc[l] : nullptr;
  }
  return cg.n_lin;
}

bool cl_geometry(long long n, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0,
                 int squeeze, long long ld_feat, ColorGeom& cg) {
  cg = ColorGeom{c_n_lin, c_hidden, c_multires, d_feat, c_k0, squeeze};
  return c_k0 % 4 == 0 && d_feat <= c_k0 && ld_feat >= d_feat && c_n_lin >= 2 &&
         c_n_lin <= kMaxColorLayers && n >= 0;
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// Device floats the backward needs beside its inputs and outputs:
// out[0] staged rows, out[1] the reduction's partial sums, out[2] 0 (no
// per-block scratch).
extern "C" int copenerf_color_bwd_workspace(long long n, int d_feat, int c_n_lin, int c_hidden,
                                            int c_multires, int c_k0, long long* out) {
  ColorGeom cg;
  if (!cl_geometry(n, d_feat, c_n_lin, c_hidden, c_multires, c_k0, 1, d_feat, cg))
    return (int)cudaErrorInvalidValue;
  ClStages st;
  out[0] = cl_stage_layout(cg, n, nullptr, st);
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = cl_jobs(cg, st, nullptr, nullptr, nullptr, jobs);
  out[1] = wgrad_partial_floats(jobs, n_jobs, n);
  out[2] = 0;
  return 0;
}

// x_bar (n, 4), dirs_bar (n, 3), grad_bar (n, 4), feat_bar (n, d_feat) and
// the color weight gradients (into `grads` at off_gwc / off_gbc, pack.py
// `color_grad_layout`) for the cotangent cbar (n, 3) of K5-fwd's color at
// the same inputs. The weight offsets are K5-fwd's plus, per hidden layer,
// W^T as wgmma B (off_wctp; layer 0's columns < 256), off_wct0tp (layer 0's
// columns 256 .. c_k0 as wgmma B, 0 when c_k0 <= 256) and off_wct_last (the
// head's W (3, hidden)). Returns the first CUDA error.
extern "C" int copenerf_color_bwd(
    const float* x, const float* dirs, const float* grad, const float* feat, long long ld_feat,
    const float* cbar, float* xbar, float* dbar, float* gbar, float* fbar, const float* params,
    const long long* off_wcp, const long long* off_wctp, const long long* off_bc,
    long long off_wct0tp, long long off_wc_last, long long off_wct_last, float* grads,
    const long long* off_gwc, const long long* off_gbc, float* stage, float* partial,
    long long n, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0, int squeeze,
    void* stream) {
  if (n <= 0) return 0;
  ColorGeom cg;
  if (!cl_geometry(n, d_feat, c_n_lin, c_hidden, c_multires, c_k0, squeeze, ld_feat, cg) ||
      (c_k0 > kSliceCols && off_wct0tp == 0))
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (!make_color_offsets(off, c_n_lin, off_wcp, off_wctp, off_wct0tp, off_bc, off_wc_last,
                          off_wct_last))
    return (int)cudaErrorInvalidValue;
  ClStages st;
  cl_stage_layout(cg, n, stage, st);
  const size_t smem =
      sizeof(float) * (kRows * G::kLd + kRows * c_k0 + 4 * kRows * 4 + G::kWsFloats);
  cudaError_t err = cudaFuncSetAttribute(color_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  cudaStream_t s = (cudaStream_t)stream;
  color_bwd_kernel<<<(unsigned)tiles, kThreads, smem, s>>>(x, dirs, grad, feat, ld_feat, cbar,
                                                            xbar, dbar, gbar, fbar, params, off,
                                                            n, cg, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = cl_jobs(cg, st, grads, off_gwc, off_gbc, jobs);
  return (int)wgrad_tc_launch(jobs, n_jobs, n, partial, s);
}
