// K3-bwd — the first-order backward of the differentiable SDF value.
//
// Replaces: copenerf_tpu/ops/pallas/sdf_kernels.py `_build` ->
// `make_bwd_kernel(second_order=False, value_only=True)` (launched by
// `call_bwd`, exposed as `FusedOps.value_diff`). One launch per train step:
// the sdf-consistency re-query at the world-transformed samples (131,072
// rows at the reference protocol). Its forward, K3-fwd, is K2's kernel
// (sdf_value.cu): the same function, column 0 of the head.
//
// Computes, per row x with cotangent obar of sdf = (h . W_last[:, 0] + b) /
// scale: recompute the forward (keeping every layer's input T_l and
// sigmoid(100 z)), then the channel-A down-sweep z_l = (z_{l+1} W_{l+1}) *
// sigmoid(100 z_l), split at the skip (h | e) / sqrt(2), to
// x_bar = J_pe^T e_hat * scale. The weight gradients sum_rows z_l^T T_l (the
// last layer only its row 0) and b gradients sum_rows z_l are reduced by
// wgrad.cu from the staged T_l and z_l.
//
// Bound on an H100: operations. ~2.75 MFLOP per row (forward 0.92, sweep
// 0.92, weight reduction 0.92) against ~36 bytes of rows in and out; the
// staged rows (~16 KB a row, written once, read back by the reduction) are
// the design's own traffic, not the function's.
// Design: the row kernel is sdf_value.cu's tile (64 rows, activations in
// shared memory, 64-deep weight slices) run forward, then backward over W^T
// in place in the same buffer; the sigmoids go to a per-block scratch in
// device memory (persistent grid, one block per SM). Rows past n are never
// staged, so the ragged tail adds nothing to the weight gradients.
#include "mlp_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 64;

__global__ void __launch_bounds__(kThreads, 1)
sdf_value_bwd_kernel(const float* __restrict__ x, const float* __restrict__ obar,
                     float* __restrict__ xbar, const float* __restrict__ P, Offsets off,
                     float* __restrict__ scratch, long long n, SdfGeom g, StageSet st_t,
                     StageSet st_z) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* e = h + kRows * kSliceCols;
  float* xs = e + kRows * g.d0;
  float* zs = xs + kRows * 4;
  float* w_s = zs + kRows;
  const int n_hidden = g.n_lin - 1;
  float* sig_s = scratch + (long long)blockIdx.x * n_hidden * kRows * 256;
  const long long tiles = (n + kRows - 1) / kRows;
  const int split = g.hidden - g.d0;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kRows; i += kThreads)
      zs[i] = row0 + i < n ? obar[row0 + i] / g.scale : 0.0f;
    load_and_encode(x, n, row0, g, xs, e);
    for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {  // as e was written
      const int r = i / g.d0;
      stage_put(st_t, 0, row0 + r, n, i - r * g.d0, e[i]);
    }

    // ---- forward: layer inputs to the stage, sigmoids to the scratch ----
    sdf_hidden_forward<kSliceK>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) {
          sig_s[((long long)l * kRows + r) * 256 + c] = sig;
        },
        [&](int l, int r, int c, float v) { stage_put(st_t, l, row0 + r, n, c, v); });
    __syncthreads();

    // ---- head: z = obar / scale (the last layer's row 0 only) ----
    {
      const float* w0 = P + off.w_last0;
      const int l = n_hidden - 1;
      const int width = sdf_out_dim(g, l);
      for (int i = threadIdx.x; i < kRows; i += kThreads)
        stage_put(st_z, n_hidden, row0 + i, n, 0, zs[i]);
      for (int i = threadIdx.x; i < kRows * width; i += kThreads) {
        const int r = i / width, c = i - r * width;
        h[r * 256 + c] = zs[r] * w0[c] * sig_s[((long long)l * kRows + r) * 256 + c];
      }
    }

    // ---- down-sweep: stage z_l, then z_l @ W_l (over W^T) ----
    for (int l = n_hidden - 1; l >= 0; --l) {
      const int K = sdf_out_dim(g, l);
      const int N = sdf_in_dim(g, l);
      const bool at_skip = (l == g.skip);
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
        const int r = i / K;
        stage_put(st_z, l, row0 + r, n, i - r * K, h[r * 256 + (i - r * K)]);
      }
      gemm<kSliceK>(h, 256, K, P + off.wt[l], N, N, w_s, [&](int r, int c, float v) {
        if (at_skip) {
          v *= kInvSqrt2;
          if (c >= split) {  // the PE part of the skip input
            e[r * g.d0 + (c - split)] = v;
            return;
          }
        }
        if (l > 0)
          h[r * 256 + c] = v * sig_s[((long long)(l - 1) * kRows + r) * 256 + c];
        else
          h[r * 256 + c] = g.skip > 0 ? v + e[r * g.d0 + c] : v;
      });
    }
    // h now holds e_hat (d0 wide): x_bar = J_pe^T e_hat * scale.
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      if (gr < n) xbar[gr * 4 + j] = pe4_jac_t(h + r * 256, xs + r * 4, g.multires, j) * g.scale;
    }
  }
}

// The staged matrices: T_l (input of SDF layer l, l < n_lin) and z_l (its
// output cotangent; the last layer's is one column). With base null only
// the size is counted. Returns the floats used.
long long value_stage_layout(const SdfGeom& g, long long n, float* base, StageSet& t,
                             StageSet& z) {
  long long used = 0;
  auto take = [&](StageSet& s, int l, int width) {
    const int ld = (width + 3) & ~3;
    s.p[l] = base ? base + used : nullptr;
    s.ld[l] = ld;
    used += n * ld;
  };
  for (int l = 0; l < g.n_lin; ++l) {
    take(t, l, sdf_in_dim(g, l));
    take(z, l, l == g.n_lin - 1 ? 1 : sdf_out_dim(g, l));
  }
  return used;
}

int value_jobs(const SdfGeom& g, const StageSet& t, const StageSet& z, float* grads,
               const long long* off_gw, const long long* off_gb, WgradJob* jobs) {
  for (int l = 0; l < g.n_lin; ++l) {
    WgradJob& j = jobs[l];
    j.O = l == g.n_lin - 1 ? 1 : sdf_out_dim(g, l);
    j.I = sdf_in_dim(g, l);
    j.n_pairs = 1;
    j.p[0] = WgradPair{z.p[l], t.p[l], z.ld[l], t.ld[l]};
    j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
    j.w_out = grads ? grads + off_gw[l] : nullptr;
    j.b_out = grads ? grads + off_gb[l] : nullptr;
  }
  return g.n_lin;
}

size_t value_bwd_smem(const SdfGeom& g) {
  return sizeof(float) * (kRows * kSliceCols + kRows * g.d0 + kRows * 4 + kRows +
                          2 * kSliceK * kSliceCols);
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// Device floats the backward needs beside its inputs and outputs:
// out[0] staged rows, out[1] the reduction's partial sums, out[2] the
// per-block sigmoid scratch for n_blocks blocks.
extern "C" int copenerf_sdf_value_bwd_workspace(long long n, int n_lin, int d_in, int multires,
                                                int hidden, int skip, int n_blocks,
                                                long long* out) {
  if (n_lin - 1 > kMaxSdfHidden || n_lin < 2) return (int)cudaErrorInvalidValue;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, 1.0f};
  StageSet t, z;
  out[0] = value_stage_layout(g, n, nullptr, t, z);
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = value_jobs(g, t, z, nullptr, nullptr, nullptr, jobs);
  out[1] = wgrad_partial_floats(jobs, n_jobs, n);
  out[2] = (long long)n_blocks * (n_lin - 1) * kRows * 256;
  return 0;
}

// x_bar (n, 4) and the weight gradients (into `grads` at off_gw / off_gb
// per layer, pack.py `sdf_value_grad_layout`) of sdf(x (n, 4)) for the
// cotangent obar (n,). The off_* weight arguments are float offsets into
// `params` as for copenerf_sdf_value, plus W^T per hidden layer. Returns the
// first CUDA error.
extern "C" int copenerf_sdf_value_bwd(
    const float* x, const float* obar, float* xbar, const float* params,
    const long long* off_w, const long long* off_b, const long long* off_wt,
    long long off_w_last0, long long off_b_last0, float* grads, const long long* off_gw,
    const long long* off_gb, float* stage, float* partial, float* scratch, long long n,
    int n_lin, int d_in, int multires, int hidden, int skip, float scale, int n_blocks,
    void* stream) {
  if (n <= 0) return 0;
  if (d_in != 4) return (int)cudaErrorInvalidValue;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_w, off_b, off_wt, off_w_last0, off_b_last0, 0, 0, 0,
                    nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  StageSet t, z;
  value_stage_layout(g, n, stage, t, z);
  const size_t smem = value_bwd_smem(g);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_value_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  sdf_value_bwd_kernel<<<grid, kThreads, smem, s>>>(x, obar, xbar, params, off, scratch, n, g,
                                                     t, z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = value_jobs(g, t, z, grads, off_gw, off_gb, jobs);
  return (int)wgrad_launch(jobs, n_jobs, n, partial, s);
}
