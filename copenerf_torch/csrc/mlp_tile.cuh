// Shared device helpers of the port's field kernels (sdf_value.cu,
// rendercore_fwd.cu, sdf_value_bwd.cu, rendercore_bwd.cu): the row-tile
// layout, the f32 FFMA tile GEMM, the per-row dot for narrow heads, the
// positional encoding and its Jacobian products, the shared-exp softplus-100
// and the per-row staging of the backward kernels.
//
// Layout: a block of 256 threads (8 warps) owns a tile of kRows = 64 rows.
// Activations live in shared memory, one 256-float line per row; warp w owns
// rows [8w, 8w + 8) in every GEMM, so a GEMM may write its output over its
// input. In the GEMM each lane owns 8 output columns
// (lane*4 + 0..3 and 128 + lane*4 + 0..3), so one thread accumulates an
// 8 x 8 block: per k it reads 8 row values (broadcast, float4 over k) and two
// float4 of the weight slice for 64 FFMAs. Weights stream from device memory
// (L2-resident: a few MB in all) through a KS x 256 shared-memory slice.
// Everything is f32 (no TF32, no bf16): the sharpened NeuS alpha cannot
// tolerate bf16-level SDF error.
#pragma once

#include <cuda_runtime.h>

namespace copenerf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kSliceCols = 256;               // widest GEMM output per pass
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// Offsets (in floats) of each packed tensor inside the parameter buffer,
// passed by name through the C entry points; copenerf_torch/ops/kernels/
// pack.py decides the layout. Unused entries are 0.
constexpr int kMaxSdfHidden = 16;
constexpr int kMaxColorLayers = 6;
struct Offsets {
  long long w[kMaxSdfHidden];      // SDF hidden layer l: W (in, out)
  long long b[kMaxSdfHidden];      // (out,)
  long long wt[kMaxSdfHidden];     // W^T (out, in), for the gradient sweep
  long long w_last0, b_last0;      // last SDF layer, column 0: (hidden,), (1,)
  long long w_feat, b_feat;        // columns 1..: (hidden, d_feat), (d_feat,)
  long long wc[kMaxColorLayers];   // color layer l: W (in, out)
  long long bc[kMaxColorLayers];   // (out,)
  long long wct[kMaxColorLayers];  // W^T (out, in), for the color backward
  long long w_feat_t;              // feature columns as (d_feat, hidden)
};

// Host: fill `off` from the entry point's named offsets of n_hidden SDF
// hidden layers (wt may be null) and n_color color layers (wc, bc may be
// null). False when a count exceeds the struct.
inline bool make_offsets(Offsets& off, int n_hidden, const long long* w,
                         const long long* b, const long long* wt, long long w_last0,
                         long long b_last0, long long w_feat, long long b_feat,
                         int n_color, const long long* wc, const long long* bc) {
  if (n_hidden < 1 || n_hidden > kMaxSdfHidden || n_color < 0 || n_color > kMaxColorLayers)
    return false;
  off = Offsets{};
  for (int l = 0; l < n_hidden; ++l) {
    off.w[l] = w[l];
    off.b[l] = b[l];
    if (wt) off.wt[l] = wt[l];
  }
  off.w_last0 = w_last0;
  off.b_last0 = b_last0;
  off.w_feat = w_feat;
  off.b_feat = b_feat;
  for (int l = 0; l < n_color; ++l) {
    off.wc[l] = wc[l];
    off.bc[l] = bc[l];
  }
  return true;
}

// Static geometry of the SDF MLP (models/fields.SDFConfig).
struct SdfGeom {
  int n_lin;      // linear layers (9 at the default config)
  int d_in;       // 4: (x, y, z, t)
  int multires;   // PE frequencies
  int d0;         // PE width = d_in * (1 + 2 * multires)
  int hidden;     // 256
  int skip;       // layer whose input is [h, e] / sqrt(2); -1 for none
  float scale;
};

// Static geometry of the IDR color MLP (models/fields.ColorConfig).
struct ColorGeom {
  int n_lin;     // 5 at the default config
  int hidden;    // 256
  int multires;  // view-dir PE frequencies
  int d_feat;    // 256
  int k0;        // padded input width (292): the color-input row stride
  int squeeze;   // sigmoid head
};

// Per-row matrices the backward kernels stage in device memory for the
// weight-gradient reduction (wgrad.cuh): entry l holds row gr of its matrix
// at p[l] + gr * ld[l]. Only rows < n are written.
constexpr int kMaxStages = kMaxSdfHidden + 1;
struct StageSet {
  float* p[kMaxStages];
  int ld[kMaxStages];
};

__device__ __forceinline__ void stage_put(const StageSet& s, int l, long long gr,
                                          long long n, int c, float v) {
  if (gr < n) s.p[l][gr * s.ld[l] + c] = v;
}

// Value of row gr, column c of staged matrix l; 0 past the last row.
__device__ __forceinline__ float stage_get(const StageSet& s, int l, long long gr,
                                           long long n, int c) {
  return gr < n ? s.p[l][gr * s.ld[l] + c] : 0.0f;
}

__host__ __device__ __forceinline__ int sdf_in_dim(const SdfGeom& g, int l) {
  return l == 0 ? g.d0 : g.hidden;
}
// Output width of hidden layer l (the layer feeding the skip is narrower).
__host__ __device__ __forceinline__ int sdf_out_dim(const SdfGeom& g, int l) {
  return (l + 1 == g.skip) ? g.hidden - g.d0 : g.hidden;
}

// (sigmoid(100 z), softplus(100 z) / 100) from one shared exp
// (copenerf_tpu/ops/pallas/sdf_kernels.py _sig_softplus100). The hardware
// exp2/log2/rcp paths: eu lies in (0, 1], where __expf is within a few ulp,
// __logf(1 + eu) within 2^-21 absolute (x 0.01 in sp) and the reciprocal is
// rounded. The precise library calls (several times the instructions, with
// branches) made this epilogue a large share of each layer's instructions;
// without them both kernels are faster at the same error against their plain
// versions (PERF.md).
__device__ __forceinline__ void sig_softplus100(float z, float& sig, float& sp) {
  const float eu = __expf(-fabsf(100.0f * z));
  const float inv = __frcp_rn(1.0f + eu);
  sig = z > 0.0f ? inv : eu * inv;
  sp = fmaxf(z, 0.0f) + __logf(1.0f + eu) * 0.01f;
}

// Column c of the positional encoding of one d-wide row:
// [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(m-1) x), cos(2^(m-1) x)].
__device__ __forceinline__ float pe_value(const float* row, int d, int c) {
  if (c < d) return row[c];
  const int t = c - d;
  const int k = t / (2 * d);
  const int rem = t - k * 2 * d;
  const float a = row[rem % d] * (float)(1 << k);
  return rem < d ? sinf(a) : cosf(a);
}

// 16-byte global -> shared copy; with `pred` false it writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of weight rows [k0, k0 + KS) x columns [0, 128 * NG) into a
// KS x kSliceCols slice (rows >= K and columns >= N zero-filled) and commit
// it as one cp.async group. ldw, N and the base are multiples of 4 floats.
template <int NG, int KS>
__device__ __forceinline__ void load_slice(const float* __restrict__ W, int ldw, int N,
                                           int K, int k0, float* dst) {
  constexpr int kChunksPerRow = 32 * NG;  // float4 chunks per slice row
  for (int idx = threadIdx.x; idx < KS * kChunksPerRow; idx += kThreads) {
    const int kk = idx / kChunksPerRow;
    const int c = (idx - kk * kChunksPerRow) * 4;
    const bool ok = (k0 + kk < K) && (c < N);
    cp_async16(dst + kk * kSliceCols + c, ok ? W + (long long)(k0 + kk) * ldw + c : W,
               ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[r][c] = epi(r, c, sum_k in[r][k] * W[k * ldw + c]) for this warp's rows
// and c < N <= 128 * NG. K, N and ldw must be multiples of 4 and `in` rows
// 16-byte aligned; w_s holds two KS x 256 slices. A __syncthreads() precedes
// the first multiply, so writes made to `in` before the call are visible;
// the epilogue runs after the last barrier (each warp writes only its own
// rows, and nothing reads w_s outside a GEMM), so `out` may be `in`.
template <int NG, int KS>
__device__ __forceinline__ void gemm_mainloop(const float* in, int ld_in,
                                              int K, const float* __restrict__ W,
                                              int ldw, int N, float* __restrict__ w_s,
                                              float (&acc)[kRowsPerWarp][4 * NG]) {
  constexpr int RPW = kRowsPerWarp;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPW;
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.0f;

  // Double-buffered weight slices: slice s+1 is in flight (cp.async) while
  // slice s is multiplied.
  const int n_slices = (K + KS - 1) / KS;
  load_slice<NG, KS>(W, ldw, N, K, 0, w_s);
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      load_slice<NG, KS>(W, ldw, N, K, (s + 1) * KS,
                         w_s + ((s + 1) & 1) * KS * kSliceCols);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s (and writes made to `in`) visible to all
    const float* ws = w_s + (s & 1) * KS * kSliceCols;
    const int k0 = s * KS;
    const int kn = min(KS, K - k0);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        a[i] = *reinterpret_cast<const float4*>(in + (r0 + i) * ld_in + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wrow = ws + (kk + q) * kSliceCols + lane * 4;
        const float4 w0 = *reinterpret_cast<const float4*>(wrow);
        float4 w1 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (NG == 2) w1 = *reinterpret_cast<const float4*>(wrow + 128);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, w0.x, acc[i][0]);
          acc[i][1] = fmaf(av, w0.y, acc[i][1]);
          acc[i][2] = fmaf(av, w0.z, acc[i][2]);
          acc[i][3] = fmaf(av, w0.w, acc[i][3]);
          if (NG == 2) {
            acc[i][4 % (4 * NG)] = fmaf(av, w1.x, acc[i][4 % (4 * NG)]);
            acc[i][5 % (4 * NG)] = fmaf(av, w1.y, acc[i][5 % (4 * NG)]);
            acc[i][6 % (4 * NG)] = fmaf(av, w1.z, acc[i][6 % (4 * NG)]);
            acc[i][7 % (4 * NG)] = fmaf(av, w1.w, acc[i][7 % (4 * NG)]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refilling
  }
}

// Column of accumulator j of this lane.
__device__ __forceinline__ int acc_col(int j) {
  const int lane = threadIdx.x & 31;
  return (j < 4) ? lane * 4 + j : 128 + lane * 4 + (j - 4);
}

template <int NG, class Epi>
__device__ __forceinline__ void gemm_epilogue(int N, const float (&acc)[kRowsPerWarp][4 * NG],
                                              Epi epi) {
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) {
      const int c = acc_col(j);
      if (c < N) epi(r0 + i, c, acc[i][j]);
    }
}

template <int NG, int KS, class Epi>
__device__ __forceinline__ void gemm_rows(const float* in, int ld_in,
                                          int K, const float* __restrict__ W,
                                          int ldw, int N, float* __restrict__ w_s,
                                          Epi epi) {
  float acc[kRowsPerWarp][4 * NG];
  gemm_mainloop<NG, KS>(in, ld_in, K, W, ldw, N, w_s, acc);
  gemm_epilogue<NG>(N, acc, epi);
}

// Dispatch on the output width: one 128-column group when it suffices.
template <int KS, class Epi>
__device__ __forceinline__ void gemm(const float* in, int ld_in, int K,
                                     const float* __restrict__ W, int ldw, int N,
                                     float* __restrict__ w_s, Epi epi) {
  if (N > 128)
    gemm_rows<2, KS>(in, ld_in, K, W, ldw, N, w_s, epi);
  else
    gemm_rows<1, KS>(in, ld_in, K, W, ldw, N, w_s, epi);
}

// Narrow head (N <= 4 columns): one warp reduction per row and column.
// Needs a __syncthreads() before it if `in` was written by other warps'
// element-wise passes. Lane 0 calls epi(r, n, value).
template <class Epi>
__device__ __forceinline__ void rowdot(const float* __restrict__ in, int ld_in, int K,
                                       const float* __restrict__ W, int ldw, int N,
                                       Epi epi) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = lane; k < K; k += 32) {
      const float a = in[r * ld_in + k];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (n < N) s[n] = fmaf(a, __ldg(W + (long long)k * ldw + n), s[n]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[n] += __shfl_xor_sync(0xffffffffu, s[n], o);
    if (lane == 0)
      for (int n = 0; n < N; ++n) epi(r, n, s[n]);
  }
}

// Scaled inputs of the tile: xs[r][0..d_in) = x * scale for valid rows, 0 for
// the ragged tail (so every value stays finite), then the PE into e.
__device__ __forceinline__ void load_and_encode(const float* __restrict__ x, long long n,
                                                long long row0, const SdfGeom& g,
                                                float* xs, float* e) {
  for (int i = threadIdx.x; i < kRows * g.d_in; i += kThreads) {
    const int r = i / g.d_in;
    const long long gr = row0 + r;
    xs[i] = gr < n ? x[gr * g.d_in + (i - r * g.d_in)] * g.scale : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {
    const int r = i / g.d0;
    e[i] = pe_value(xs + r * g.d_in, g.d_in, i - r * g.d0);
  }
}

// The SDF hidden layers 0 .. n_lin-2 into the kRows x 256 buffer h, starting
// from the PE in e; every layer after the first runs in place (a warp's
// output rows are the rows it read, written after its last read).
// `keep(l, r, c, sig)` sees every sigmoid(100 z); `put(l, r, c, v)` sees
// every value v written as column c of layer l's input (l >= 1: the
// previous layer's output and the skip layer's scaled PE part).
template <int KS, class Keep, class Put>
__device__ __forceinline__ void sdf_hidden_forward(const float* __restrict__ P,
                                                   const Offsets& off, const SdfGeom& g,
                                                   const float* e, float* h, float* w_s,
                                                   Keep keep, Put put) {
  for (int l = 0; l < g.n_lin - 1; ++l) {
    if (l == g.skip) {
      // Input of the skip layer: [h, e] / sqrt(2); h was scaled in the
      // previous epilogue, append the scaled PE.
      const int split = g.hidden - g.d0;
      for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {
        const int r = i / g.d0;
        const float v = e[i] * kInvSqrt2;
        h[r * kSliceCols + split + (i - r * g.d0)] = v;
        put(l, r, split + (i - r * g.d0), v);
      }
    }
    const float* bias = P + off.b[l];
    const bool pre_skip = (l + 1 == g.skip);
    gemm<KS>(l == 0 ? e : h, l == 0 ? g.d0 : kSliceCols, sdf_in_dim(g, l),
             P + off.w[l], sdf_out_dim(g, l), sdf_out_dim(g, l), w_s,
             [&](int r, int c, float z) {
               float sig, sp;
               sig_softplus100(z + bias[c], sig, sp);
               keep(l, r, c, sig);
               const float v = pre_skip ? sp * kInvSqrt2 : sp;
               h[r * kSliceCols + c] = v;
               put(l + 1, r, c, v);
             });
  }
}

// d(sdf)/dx of one row from ee = d(sdf)/d(PE) (J_pe^T ee, d_in = 4): the
// PE of xs = x * scale is [xs, sin(2^0 xs), cos(2^0 xs), ...], 4 wide each.
__device__ __forceinline__ float pe4_jac_t(const float* ee, const float* xs, int multires,
                                           int j) {
  float acc = ee[j];
  for (int k = 0; k < multires; ++k) {
    const float f = (float)(1 << k);
    const float a = xs[j] * f;
    const int cs = 4 + k * 8 + j;
    acc += ee[cs] * (cosf(a) * f);
    acc += ee[cs + 4] * (-sinf(a) * f);
  }
  return acc;
}

// Column c of J_pe gb for one row (d_in = 4): the PE-wide image of a
// cotangent gb (4) of xs.
__device__ __forceinline__ float pe4_jac(const float* gb, const float* xs, int c) {
  if (c < 4) return gb[c];
  const int t = c - 4;
  const int k = t >> 3;
  const int rem = t - (k << 3);
  const int j = rem & 3;
  const float f = (float)(1 << k);
  const float a = xs[j] * f;
  return rem < 4 ? gb[j] * f * cosf(a) : -gb[j] * f * sinf(a);
}

}  // namespace copenerf
