// K3-bwd — the first-order backward of the differentiable SDF value — and
// K7-bwd — the first-order backward of the full SDF output.
//
// Replaces: copenerf_tpu/ops/pallas/sdf_kernels.py `_build` ->
// `make_bwd_kernel(second_order=False)` (launched by `call_bwd`):
//   * K3-bwd (`value_only=True`, exposed as `FusedOps.value_diff`): one
//     launch per train step, the sdf-consistency re-query at the
//     world-transformed samples (131,072 rows at the reference protocol).
//     Its forward, K3-fwd, is K2's kernel (sdf_value.cu): the same function,
//     column 0 of the head.
//   * K7-bwd (`value_only=False`, exposed as `FusedOps.out`, reached through
//     `fields.sdf_output`): the whole head [sdf, feature]. Its forward, K7-fwd,
//     is K4-fwd's kernel without the gradient sweep (sdf_outgrad_fwd.cu).
//
// Computes, per row x with cotangent obar of the head's z = h W_last + b
// (out = [z_0 / scale, z_1..]): recompute the forward (keeping every layer's
// input T_l and sigmoid(100 z)), then the head's cotangent z_head = [obar_0
// / scale, obar_1..] (K3: column 0 alone), z_L = (z_head W_last) * sigmoid
// (K7's feature part by a GEMM over W_feat^T), and the channel-A down-sweep
// z_l = (z_{l+1} W_{l+1}) * sigmoid(100 z_l), split at the skip (h | e) /
// sqrt(2), to x_bar = J_pe^T e_hat * scale. The weight gradients
// sum_rows z_l^T T_l (the last layer: K3 its row 0, K7 all of it) and b
// gradients sum_rows z_l are reduced by wgrad.cu from the staged T_l and z_l.
//
// Bound on an H100: operations. K3: ~2.75 MFLOP per row (forward 0.92,
// sweep 0.92, weight reduction 0.92) against ~36 bytes of rows in and out;
// K7: ~3.4 MFLOP per row (each of the three over the full head) against
// ~1,060 bytes (obar is 257 wide). The staged rows (~16 KB a row, written
// once, read back by the reduction) are the design's own traffic, not the
// function's.
// Design: the row kernel is sdf_value.cu's tile (64 rows, activations in
// shared memory, 64-deep weight slices) run forward, then backward over W^T
// in place in the same buffer; the sigmoids go to a per-block scratch in
// device memory (persistent grid, one block per SM). K7's feature cotangent
// is read into the activation buffer once the forward has staged it, and
// the head's GEMM writes z_L over it, so K7 needs no more shared memory than
// K3. Rows past n are never staged, so the ragged tail adds nothing to the
// weight gradients.
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

// K7-bwd: the same row kernel over the whole head. obar is (n, d_out); the
// feature cotangent goes into h once the forward has staged the last
// hidden layer's output, and the head's GEMM writes z_L over it.
__global__ void __launch_bounds__(kThreads, 1)
sdf_out_bwd_kernel(const float* __restrict__ x, const float* __restrict__ obar,
                   float* __restrict__ xbar, const float* __restrict__ P, Offsets off,
                   float* __restrict__ scratch, long long n, SdfGeom g, int d_out,
                   StageSet st_t, StageSet st_z) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* e = h + kRows * kSliceCols;
  float* xs = e + kRows * g.d0;
  float* zs = xs + kRows * 4;
  float* w_s = zs + kRows;
  const int n_hidden = g.n_lin - 1;
  const int lh = n_hidden - 1;
  const int d_feat = d_out - 1;
  float* sig_s = scratch + (long long)blockIdx.x * n_hidden * kRows * 256;
  const long long tiles = (n + kRows - 1) / kRows;
  auto sig_at = [&](int l, int r, int c) { return sig_s[((long long)l * kRows + r) * 256 + c]; };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kRows; i += kThreads)
      zs[i] = row0 + i < n ? obar[(row0 + i) * d_out] / g.scale : 0.0f;
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

    // ---- head: z_head = [obar_0 / scale, obar_1..] staged whole, z_L =
    // (z_head W_last) * sig_L into h, the feature part by a GEMM over
    // W_feat^T from the feature cotangent read into h ----
    for (int i = threadIdx.x; i < kRows * d_out; i += kThreads) {
      const int r = i / d_out, c = i - r * d_out;
      const long long gr = row0 + r;
      if (gr < n) stage_put(st_z, n_hidden, gr, n, c, c == 0 ? zs[r] : obar[gr * d_out + c]);
    }
    for (int i = threadIdx.x; i < kRows * d_feat; i += kThreads) {
      const int r = i / d_feat, c = i - r * d_feat;
      const long long gr = row0 + r;
      h[r * 256 + c] = gr < n ? obar[gr * d_out + 1 + c] : 0.0f;
    }
    {
      const float* w0 = P + off.w_last0;
      gemm<kSliceK>(h, 256, d_feat, P + off.w_feat_t, g.hidden, g.hidden, w_s,
                    [&](int r, int c, float v) {
                      h[r * 256 + c] = fmaf(zs[r], w0[c], v) * sig_at(lh, r, c);
                    });
    }

    // ---- down-sweep: stage z_l, then z_l @ W_l (over W^T) ----
    sdf_down_sweep_a<kSliceK>(P, off, g, h, e, w_s, sig_at, [&](int l, int r, int c, float v) {
      stage_put(st_z, l, row0 + r, n, c, v);
    });
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
// output cotangent; the last layer's is d_head columns: 1 for K3, d_out for
// K7). With base null only the size is counted. Returns the floats used.
long long value_stage_layout(const SdfGeom& g, int d_head, long long n, float* base,
                             StageSet& t, StageSet& z) {
  long long used = 0;
  auto take = [&](StageSet& s, int l, int width) {
    const int ld = (width + 3) & ~3;
    s.p[l] = base ? base + used : nullptr;
    s.ld[l] = ld;
    used += n * ld;
  };
  for (int l = 0; l < g.n_lin; ++l) {
    take(t, l, sdf_in_dim(g, l));
    take(z, l, l == g.n_lin - 1 ? d_head : sdf_out_dim(g, l));
  }
  return used;
}

int value_jobs(const SdfGeom& g, int d_head, const StageSet& t, const StageSet& z, float* grads,
               const long long* off_gw, const long long* off_gb, WgradJob* jobs) {
  for (int l = 0; l < g.n_lin; ++l) {
    WgradJob& j = jobs[l];
    j.O = l == g.n_lin - 1 ? d_head : sdf_out_dim(g, l);
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

bool value_geometry(int n_lin, int d_in, int multires, int hidden, int skip, float scale,
                    int d_head, SdfGeom& g) {
  g = SdfGeom{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  return d_in == 4 && n_lin >= 2 && n_lin - 1 <= kMaxSdfHidden &&
         (d_head == 1 || (d_head >= 5 && (d_head - 1) % 4 == 0 && d_head - 1 <= kSliceCols));
}

int value_bwd_workspace(long long n, int n_lin, int d_in, int multires, int hidden, int skip,
                        int d_head, int n_blocks, long long* out) {
  SdfGeom g;
  if (!value_geometry(n_lin, d_in, multires, hidden, skip, 1.0f, d_head, g))
    return (int)cudaErrorInvalidValue;
  StageSet t, z;
  out[0] = value_stage_layout(g, d_head, n, nullptr, t, z);
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = value_jobs(g, d_head, t, z, nullptr, nullptr, nullptr, jobs);
  out[1] = wgrad_partial_floats(jobs, n_jobs, n);
  out[2] = (long long)n_blocks * (n_lin - 1) * kRows * 256;
  return 0;
}

// The row kernel and the reduction of K3-bwd (kFullHead false, d_out 1) or
// K7-bwd (sdf_out_bwd_kernel); off.w_feat_t is read by K7 alone.
template <bool kFullHead>
int value_bwd_run(const float* x, const float* obar, float* xbar, const float* params,
                  const Offsets& off, float* grads, const long long* off_gw,
                  const long long* off_gb, float* stage, float* partial, float* scratch,
                  long long n, const SdfGeom& g, int d_out, int n_blocks, void* stream) {
  StageSet t, z;
  value_stage_layout(g, d_out, n, stage, t, z);
  const size_t smem = value_bwd_smem(g);
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if constexpr (kFullHead) {
    err = cudaFuncSetAttribute(sdf_out_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sdf_out_bwd_kernel<<<grid, kThreads, smem, s>>>(x, obar, xbar, params, off, scratch, n, g,
                                                     d_out, t, z);
  } else {
    err = cudaFuncSetAttribute(sdf_value_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sdf_value_bwd_kernel<<<grid, kThreads, smem, s>>>(x, obar, xbar, params, off, scratch, n, g,
                                                       t, z);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = value_jobs(g, d_out, t, z, grads, off_gw, off_gb, jobs);
  return (int)wgrad_launch(jobs, n_jobs, n, partial, s);
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
  return value_bwd_workspace(n, n_lin, d_in, multires, hidden, skip, 1, n_blocks, out);
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
  SdfGeom g;
  Offsets off;
  if (!value_geometry(n_lin, d_in, multires, hidden, skip, scale, 1, g) ||
      !make_offsets(off, n_lin - 1, off_w, off_b, off_wt, off_w_last0, off_b_last0, 0, 0, 0,
                    nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  return value_bwd_run<false>(x, obar, xbar, params, off, grads, off_gw, off_gb, stage, partial,
                              scratch, n, g, 1, n_blocks, stream);
}

// As copenerf_sdf_value_bwd_workspace, for K7-bwd's d_out-wide head.
extern "C" int copenerf_sdf_out_bwd_workspace(long long n, int n_lin, int d_in, int multires,
                                              int hidden, int skip, int d_out, int n_blocks,
                                              long long* out) {
  if (d_out < 5) return (int)cudaErrorInvalidValue;
  return value_bwd_workspace(n, n_lin, d_in, multires, hidden, skip, d_out, n_blocks, out);
}

// x_bar (n, 4) and the weight gradients (into `grads` at off_gw / off_gb
// per layer, the last layer whole: pack.py `sdf_out_grad_layout`) of the
// head out = [sdf, feature] (n, d_out) of x (n, 4) for the cotangent obar
// (n, d_out). The weight offsets are copenerf_sdf_value_bwd's plus w_feat_t,
// the feature columns as (d_out - 1, hidden). Returns the first CUDA error.
extern "C" int copenerf_sdf_out_bwd(
    const float* x, const float* obar, float* xbar, const float* params,
    const long long* off_w, const long long* off_b, const long long* off_wt,
    long long off_w_last0, long long off_b_last0, long long off_w_feat_t, float* grads,
    const long long* off_gw, const long long* off_gb, float* stage, float* partial,
    float* scratch, long long n, int n_lin, int d_in, int multires, int hidden, int skip,
    float scale, int d_out, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  SdfGeom g;
  Offsets off;
  if (d_out < 5 || !value_geometry(n_lin, d_in, multires, hidden, skip, scale, d_out, g) ||
      !make_offsets(off, n_lin - 1, off_w, off_b, off_wt, off_w_last0, off_b_last0, 0, 0, 0,
                    nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  off.w_feat_t = off_w_feat_t;
  return value_bwd_run<true>(x, obar, xbar, params, off, grads, off_gw, off_gb, stage, partial,
                             scratch, n, g, d_out, n_blocks, stream);
}
