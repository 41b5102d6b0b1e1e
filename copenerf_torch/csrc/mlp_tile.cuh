// Shared device helpers of the port's field kernels (sdf_value.cu,
// rendercore_fwd.cu, sdf_value_bwd.cu, rendercore_bwd.cu, sdf_outgrad_*.cu,
// color_*.cu): the row-tile layout, the f32 FFMA tile GEMM, the per-row dot
// for narrow heads, the positional encoding and its Jacobian products, the
// shared-exp softplus-100, the per-row staging of the backward kernels, and
// the sweeps the render-core kernels share with the outgrad, value and color
// kernels (the SDF forward, the gradient sweep, channel B, the A + B
// down-sweep, the first-order channel-A down-sweep, the color MLP forward
// and backward).
//
// Layout: a block of 256 threads (8 warps) owns a tile of kRows = 64 rows.
// Activations live in shared memory, one 256-float line per row; warp w owns
// rows [8w, 8w + 8) in every GEMM, so a GEMM may write its output over its
// input. In the GEMM each lane owns 8 output columns
// (lane*4 + 0..3 and 128 + lane*4 + 0..3), so one thread accumulates an
// 8 x 8 block: per k it reads 8 row values (broadcast, float4 over k) and two
// float4 of the weight slice for 64 FFMAs. Weights stream from device memory
// (L2-resident: a few MB in all) through a KS x 256 shared-memory slice.
// Every value is f32 and every product at least as accurate as an f32 FFMA
// (no plain TF32, no bf16): the sharpened NeuS alpha cannot tolerate
// bf16-level SDF error. The sweeps take the GEMM as a policy (`G`), which
// also says where each hidden layer's weights are (`G::w`, `G::wt`), the
// head's feature columns (`G::wf`, `G::wft`) and each hidden color layer's
// (`G::wc`, `G::wct`, `G::wct0_tail`): every kernel passes one of
// wgmma_tile.cuh's 3xTF32 `wgmma` policies (WgGemm, WgGemm1, weights
// pre-packed by the host, activation rows of 272 floats). `gemm` (FFMA) is
// the accuracy trial's control (tc_check.cu).
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
  long long b[kMaxSdfHidden];      // SDF hidden layer l's bias (out,)
  long long w_last0, b_last0;      // last SDF layer, column 0: (hidden,), (1,)
  long long b_feat;                // the bias of columns 1.. (d_feat,)
  long long wc[kMaxColorLayers];   // color layer l: W (in, out); the head's only
  long long bc[kMaxColorLayers];   // (out,)
  long long wct[kMaxColorLayers];  // W^T (out, in); the head's only
  long long wp[kMaxSdfHidden];     // W_l as wgmma B (pack.py wg_pack_b), forward
  long long wtp[kMaxSdfHidden];    // W_l^T as wgmma B, for the down-sweep
  long long wfp;                   // feature columns as wgmma B (hidden x d_feat)
  long long wftp;                  // their transpose as wgmma B (d_feat x hidden)
  long long wcp[kMaxColorLayers];  // hidden color layer l: W_l as wgmma B (in x out)
  long long wctp[kMaxColorLayers]; // W_l^T as wgmma B (out x in; layer 0: in < 256)
  long long wct0tp;                // W_0^T's columns 256 .. k0 as wgmma B
};

// Host: fill `off` from the entry point's named offsets of n_hidden SDF
// hidden layers: per layer b, W as wgmma B and W^T as wgmma B (wtp may be
// null: the forward kernels read none), the head's column 0 and its bias,
// the feature columns' bias. False when the count exceeds the struct.
inline bool make_offsets(Offsets& off, int n_hidden, const long long* b,
                         const long long* wp, const long long* wtp, long long w_last0,
                         long long b_last0, long long b_feat) {
  if (n_hidden < 1 || n_hidden > kMaxSdfHidden) return false;
  off = Offsets{};
  for (int l = 0; l < n_hidden; ++l) {
    off.b[l] = b[l];
    off.wp[l] = wp[l];
    if (wtp) off.wtp[l] = wtp[l];
  }
  off.w_last0 = w_last0;
  off.b_last0 = b_last0;
  off.b_feat = b_feat;
  return true;
}

// Host: fill `off` for the color MLP alone (K5): n_color layers' biases, the
// hidden layers as wgmma B both ways (wctp may be null; wct0tp 0 when k0 <=
// 256), the head plain (hidden x 3) and transposed (3 x hidden).
inline bool make_color_offsets(Offsets& off, int n_color, const long long* wcp,
                               const long long* wctp, long long wct0tp, const long long* bc,
                               long long wc_last, long long wct_last) {
  if (n_color < 2 || n_color > kMaxColorLayers) return false;
  off = Offsets{};
  for (int l = 0; l < n_color; ++l) off.bc[l] = bc[l];
  for (int l = 0; l + 1 < n_color; ++l) {
    off.wcp[l] = wcp[l];
    if (wctp) off.wctp[l] = wctp[l];
  }
  off.wct0tp = wct0tp;
  off.wc[n_color - 1] = wc_last;
  off.wct[n_color - 1] = wct_last;
  return true;
}

// Host: fill `off` for the render-core kernels (K1, K6): the SDF part as
// the wgmma kernels read it (per hidden layer b, W and W^T as wgmma B; the
// head's column 0 and its bias plain, its feature columns as wgmma B both
// ways (wftp 0 for the forward) and their bias) and the color part as
// make_color_offsets fills it.
inline bool make_rendercore_offsets(Offsets& off, int n_hidden, const long long* b,
                                    const long long* wp, const long long* wtp,
                                    long long w_last0, long long b_last0, long long wfp,
                                    long long wftp, long long b_feat, int n_color,
                                    const long long* wcp, const long long* wctp,
                                    long long wct0tp, const long long* bc, long long wc_last,
                                    long long wct_last) {
  if (n_hidden < 1 || n_hidden > kMaxSdfHidden ||
      !make_color_offsets(off, n_color, wcp, wctp, wct0tp, bc, wc_last, wct_last))
    return false;
  for (int l = 0; l < n_hidden; ++l) {
    off.b[l] = b[l];
    off.wp[l] = wp[l];
    off.wtp[l] = wtp[l];
  }
  off.w_last0 = w_last0;
  off.b_last0 = b_last0;
  off.wfp = wfp;
  off.wftp = wftp;
  off.b_feat = b_feat;
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

// A hook that does nothing: the default `pre` of the GEMM policy's `run`
// and of the sweeps below.
struct NoHook {
  template <class... A>
  __device__ __forceinline__ void operator()(A...) const {}
};

// The hook a sweep hands the GEMM of its layer l: `pre(l)`, or NoHook itself
// for NoHook, so that a kernel which passes no hook compiles as though the
// sweep took none.
template <class Pre>
struct LayerHook {
  const Pre& pre;
  int l;
  __device__ __forceinline__ void operator()() const { pre(l); }
};
template <class Pre>
__device__ __forceinline__ LayerHook<Pre> layer_hook(const Pre& pre, int l) {
  return {pre, l};
}
__device__ __forceinline__ NoHook layer_hook(const NoHook&, int) { return {}; }

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

// The GEMM policy contract of the sweeps below (`G`, wgmma_tile.cuh's
// WgGemmRing): `G::kLd`, the activation row stride; `G::kWsFloats`, the
// shared floats of w_s; `G::run<KS>(in, ld_in, K, B, ldw, N, w_s, epi[,
// pre])` with `gemm`'s contract, B where `G::w` and its kin say, and every
// thread calling `pre()` after the barrier that makes `in` visible and
// before the epilogue (wg_gemm). Each sweep that takes a `pre(l)` calls it
// so inside every GEMM it names: a backward copies the GEMM's input, a
// staged matrix, to device memory there in whole rows.

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
// previous layer's output and the skip layer's scaled PE part); `pre(l)`
// runs in layer l's GEMM, whose input is layer l's (e for l = 0, else h).
template <int KS, class G, class Keep, class Put, class Pre = NoHook>
__device__ __forceinline__ void sdf_hidden_forward(const float* __restrict__ P,
                                                   const Offsets& off, const SdfGeom& g,
                                                   const float* e, float* h, float* w_s,
                                                   Keep keep, Put put, Pre pre = {}) {
  constexpr int ld = G::kLd;
  for (int l = 0; l < g.n_lin - 1; ++l) {
    if (l == g.skip) {
      // Input of the skip layer: [h, e] / sqrt(2); h was scaled in the
      // previous epilogue, append the scaled PE.
      const int split = g.hidden - g.d0;
      for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {
        const int r = i / g.d0;
        const float v = e[i] * kInvSqrt2;
        h[r * ld + split + (i - r * g.d0)] = v;
        put(l, r, split + (i - r * g.d0), v);
      }
    }
    const float* bias = P + off.b[l];
    const bool pre_skip = (l + 1 == g.skip);
    G::template run<KS>(l == 0 ? e : h, l == 0 ? g.d0 : ld, sdf_in_dim(g, l),
             G::w(P, off, l), sdf_out_dim(g, l), sdf_out_dim(g, l), w_s,
             [&](int r, int c, float z) {
               float sig, sp;
               sig_softplus100(z + bias[c], sig, sp);
               keep(l, r, c, sig);
               const float v = pre_skip ? sp * kInvSqrt2 : sp;
               h[r * ld + c] = v;
               put(l + 1, r, c, v);
             },
             layer_hook(pre, l));
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

// Column j of J_pe(dirs)^T pb for one view direction (d_in = 3): pb is the
// cotangent of [dirs, sin(2^0 dirs), cos(2^0 dirs), ...].
__device__ __forceinline__ float pe3_jac_t(const float* pb, const float* dirs, int multires,
                                           int j) {
  float acc = pb[j];
  for (int k = 0; k < multires; ++k) {
    const float f = (float)(1 << k);
    const float a = dirs[j] * f;
    acc += pb[3 + 6 * k + j] * (cosf(a) * f);
    acc += pb[6 + 6 * k + j] * (-sinf(a) * f);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Sweeps shared by the SDF kernels with an input gradient (rendercore_*.cu,
// sdf_outgrad_*.cu) and by the color kernels (rendercore_*.cu, color_*.cu).
// Each works on the block's 64-row tile in shared memory; `sig_at(l, r, c)`
// reads sigmoid(100 z) of SDF hidden layer l kept by the forward.
// ---------------------------------------------------------------------------

// The input-gradient reverse sweep (sdf_kernels.py `_grad_sweep_tile`) in h:
// u_{L} = W_last[:, 0] * sig_L (L the last hidden layer), then for l = L down
// to l_stop: r_l = u_l W_l^T, split at the skip into (h | e) / sqrt(2) with
// the PE part into e, and u_{l-1} = r_l * sig_{l-1}. `put_u(l, r, c, u)` sees
// every u_l. With l_stop == 0 h ends holding ee = d(sdf)/d(PE) (d0 wide, the
// skip's PE part added); with l_stop == 1 it ends at u_0, for a backward that
// needs the u_l alone. `pre(l)` runs in the GEMM that reads u_l from h.
// Starts with a barrier.
template <int KS, class G, class Sig, class PutU, class Pre = NoHook>
__device__ __forceinline__ void sdf_grad_sweep(const float* __restrict__ P, const Offsets& off,
                                               const SdfGeom& g, float* h, float* e,
                                               float* w_s, int l_stop, Sig sig_at,
                                               PutU put_u, Pre pre = {}) {
  constexpr int ld = G::kLd;
  const int n_hidden = g.n_lin - 1;
  const int split = g.hidden - g.d0;
  __syncthreads();
  {
    const float* w0 = P + off.w_last0;
    const int l = n_hidden - 1;
    const int width = sdf_out_dim(g, l);
    for (int i = threadIdx.x; i < kRows * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      const float u = w0[c] * sig_at(l, r, c);
      h[r * ld + c] = u;
      put_u(l, r, c, u);
    }
  }
  for (int l = n_hidden - 1; l >= l_stop; --l) {
    const int K = sdf_out_dim(g, l);
    const int N = sdf_in_dim(g, l);
    const bool at_skip = (l == g.skip);
    G::template run<KS>(h, ld, K, G::wt(P, off, l), N, N, w_s, [&](int r, int c, float v) {
      if (at_skip) {
        v *= kInvSqrt2;
        if (c >= split) {  // the PE part of the skip input: ee_skip
          e[r * g.d0 + (c - split)] = v;
          return;
        }
      }
      if (l > 0) {
        const float u = v * sig_at(l - 1, r, c);
        h[r * ld + c] = u;
        put_u(l - 1, r, c, u);
      } else {
        h[r * ld + c] = g.skip > 0 ? v + e[r * g.d0 + c] : v;
      }
    }, layer_hook(pre, l));
  }
}

// Channel B of the second-order backward, up-sweep (sdf_kernels.py
// :361-380): the double backprop of grad = J_pe^T ee for a cotangent gb of
// grad (4 per row at gb_s): p_0 = J_pe gb, then per hidden layer q_l = p_l W_l
// (with p_0 / sqrt(2) appended at the skip), zB_l = q_l u_l 100 (1 - sig_l)
// (written through `zb_at(l, r, c)`, u_l read through `u_at(l, r, c)`) and
// p_{l+1} = q_l sig_l (/ sqrt(2) before the skip). `put_p(l, r, c, v)` sees
// p_0 .. p_L+1, where p_{L+1} (L the last hidden layer) is the term of row 0
// of the last layer's W (`wlast_col0_bar`); `pre(l)` runs in the GEMM that
// reads p_l (from e for l = 0, else from h). gb_s and xs must be visible to
// every thread (a barrier before the call); h and e are overwritten.
template <int KS, class G, class Sig, class GetU, class Zb, class PutP, class Pre = NoHook>
__device__ __forceinline__ void sdf_channel_b_up(const float* __restrict__ P, const Offsets& off,
                                                 const SdfGeom& g, float* h, float* e,
                                                 float* w_s, const float* gb_s, const float* xs,
                                                 Sig sig_at, GetU u_at, Zb zb_at, PutP put_p,
                                                 Pre pre = {}) {
  constexpr int ld = G::kLd;
  const int n_hidden = g.n_lin - 1;
  const int split = g.hidden - g.d0;
  for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {
    const int r = i / g.d0, c = i - r * g.d0;
    const float v = pe4_jac(gb_s + r * 4, xs + r * 4, c);
    e[i] = v;
    put_p(0, r, c, v);
  }
  for (int l = 0; l < n_hidden; ++l) {
    if (l > 0 && l == g.skip) {
      for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {
        const int r = i / g.d0, c = i - r * g.d0;
        const float v = e[i] * kInvSqrt2;
        h[r * ld + split + c] = v;
        put_p(l, r, split + c, v);
      }
    }
    const int K = sdf_in_dim(g, l);
    const int N = sdf_out_dim(g, l);
    const bool pre_skip = (l + 1 == g.skip);
    G::template run<KS>(l == 0 ? e : h, l == 0 ? g.d0 : ld, K, G::w(P, off, l), N, N, w_s,
             [&](int r, int c, float q) {
               const float sig = sig_at(l, r, c);
               zb_at(l, r, c) = q * u_at(l, r, c) * 100.0f * (1.0f - sig);
               float v = q * sig;
               if (pre_skip) v *= kInvSqrt2;
               h[r * ld + c] = v;
               put_p(l + 1, r, c, v);
             },
             layer_hook(pre, l));
  }
}

// The last layer's cotangent and the two-channel down-sweep of the
// second-order backward (sdf_kernels.py :382-419). The head's z_A is
// [sb (sbar / scale, 1 per row), fb (the feature cotangent, d_feat per row at
// row stride ld_fb)] and z_B is 0; then h = (z_A W_last) * sig_L and hb =
// zB_L. Per hidden layer l from L down: z_l = h + hb (`put_z(l, r, c, v)`;
// the head's z_A as put_z(L + 1, ...)), channel A h = (h W_l^T) * sig_{l-1}
// with the skip's PE part into e, channel B hb = (hb W_l^T) * sig_{l-1} +
// zB_{l-1}, down to layer 1 (its x-dependence is severed). h ends holding
// e_hat = d(out)/d(PE) along channel A. fb may be hb. `pre(l)` runs in the
// GEMM that reads fb (l = L + 1; h still holds what the call found there)
// and in each channel-A GEMM (l <= L; h and hb hold z_l's two channels).
// Starts with a barrier.
template <int KS, class G, class Sig, class Zb, class PutZ, class Pre = NoHook>
__device__ __forceinline__ void sdf_down_sweep_ab(const float* __restrict__ P, const Offsets& off,
                                                  const SdfGeom& g, int d_feat, float* h,
                                                  float* hb, float* e, float* w_s,
                                                  const float* sb, const float* fb, int ld_fb,
                                                  Sig sig_at, Zb zb_at, PutZ put_z,
                                                  Pre pre = {}) {
  constexpr int ld = G::kLd;
  const int n_hidden = g.n_lin - 1;
  const int split = g.hidden - g.d0;
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * (1 + d_feat); i += kThreads) {
    const int r = i / (1 + d_feat), c = i - r * (1 + d_feat);
    put_z(n_hidden, r, c, c == 0 ? sb[r] : fb[r * ld_fb + c - 1]);
  }
  {
    const float* w0 = P + off.w_last0;
    const int lh = n_hidden - 1;
    G::template run<KS>(fb, ld_fb, d_feat, G::wft(P, off), g.hidden, g.hidden, w_s,
             [&](int r, int c, float v) {
               v = fmaf(sb[r], w0[c], v);
               h[r * ld + c] = v * sig_at(lh, r, c);
               hb[r * ld + c] = zb_at(lh, r, c);
             },
             layer_hook(pre, n_hidden));
  }
  for (int l = n_hidden - 1; l >= 0; --l) {
    const int K = sdf_out_dim(g, l);
    const int N = sdf_in_dim(g, l);
    const bool at_skip = (l == g.skip);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, c = i - r * K;
      put_z(l, r, c, h[r * ld + c] + hb[r * ld + c]);
    }
    G::template run<KS>(h, ld, K, G::wt(P, off, l), N, N, w_s, [&](int r, int c, float v) {
      if (at_skip) {
        v *= kInvSqrt2;
        if (c >= split) {
          e[r * g.d0 + (c - split)] = v;
          return;
        }
      }
      if (l > 0)
        h[r * ld + c] = v * sig_at(l - 1, r, c);
      else
        h[r * ld + c] = g.skip > 0 ? v + e[r * g.d0 + c] : v;
    }, layer_hook(pre, l));
    if (l == 0) break;  // channel B stops here: it never reaches x
    G::template run<KS>(hb, ld, K, G::wt(P, off, l), N, N, w_s, [&](int r, int c, float v) {
      if (at_skip) {
        v *= kInvSqrt2;
        if (c >= split) return;
      }
      hb[r * ld + c] = fmaf(v, sig_at(l - 1, r, c), zb_at(l - 1, r, c));
    });
  }
}

// The first-order down-sweep, channel A alone (sdf_kernels.py
// `make_bwd_kernel(second_order=False)`, rendercore_kernels.py
// `_value_only_bwd`): h holds z_L, the last hidden layer's output cotangent.
// Per hidden layer l from L down: `put_z(l, r, c, v)` sees z_l, then
// h = (z_l W_l^T) * sig_{l-1}, split at the skip (h | e) / sqrt(2) with the
// PE part into e. h ends holding e_hat = d(out)/d(PE) (d0 wide); `pre(l)`
// runs in the GEMM that reads z_l from h. Starts with a barrier. Used by
// K3-bwd and K7-bwd (on WgGemm), K6-bwd and K1-bwd's frozen-fields kernel.
template <int KS, class G, class Sig, class PutZ, class Pre = NoHook>
__device__ __forceinline__ void sdf_down_sweep_a(const float* __restrict__ P, const Offsets& off,
                                                 const SdfGeom& g, float* h, float* e,
                                                 float* w_s, Sig sig_at, PutZ put_z,
                                                 Pre pre = {}) {
  constexpr int ld = G::kLd;
  const int split = g.hidden - g.d0;
  for (int l = g.n_lin - 2; l >= 0; --l) {
    const int K = sdf_out_dim(g, l);
    const int N = sdf_in_dim(g, l);
    const bool at_skip = (l == g.skip);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K;
      put_z(l, r, i - r * K, h[r * ld + (i - r * K)]);
    }
    G::template run<KS>(h, ld, K, G::wt(P, off, l), N, N, w_s, [&](int r, int c, float v) {
      if (at_skip) {
        v *= kInvSqrt2;
        if (c >= split) {  // the PE part of the skip input
          e[r * g.d0 + (c - split)] = v;
          return;
        }
      }
      if (l > 0)
        h[r * ld + c] = v * sig_at(l - 1, r, c);
      else
        h[r * ld + c] = g.skip > 0 ? v + e[r * g.d0 + c] : v;
    }, layer_hook(pre, l));
  }
}

// The IDR color MLP (color_kernels.py `_color_forward_tile`) on the kernel's
// input order [feature, x, PE(dirs), grad, 0 pad] in cin (row stride
// cg.k0). The feature columns must be in place; the rest are filled here
// from xr (x), dr (dirs, 3 used) and gs (grad), 4 per row, which must be
// visible to every thread (a barrier before the call). Hidden layers ReLU
// into h, which may be cin (layer 0's epilogue runs after its last read of
// cin); with kStaged, `put_ci(l, r, c, v)` sees every color layer's input
// (layer 0's after a barrier), and `pre(l)` runs in the GEMM that reads
// layer l's input (cin for l = 0, else h). The head ends in `head(r, c,
// color)` for c < 3, the sigmoid applied when cg.squeeze. The 3-wide head
// is a per-row dot on the plain W (off.wc) with every policy.
template <int KS, bool kStaged, class G, class PutCi, class Head, class Pre = NoHook>
__device__ __forceinline__ void color_forward(const float* __restrict__ P, const Offsets& off,
                                              const ColorGeom& cg, float* cin, float* h,
                                              float* w_s, const float* xr, const float* dr,
                                              const float* gs, PutCi put_ci, Head head,
                                              Pre pre = {}) {
  constexpr int ld = G::kLd;
  const int d_view = 3 * (1 + 2 * cg.multires);
  const int extra = cg.k0 - cg.d_feat;
  for (int i = threadIdx.x; i < kRows * extra; i += kThreads) {
    const int r = i / extra, c = i - r * extra;
    float v = 0.0f;
    if (c < 4)
      v = xr[r * 4 + c];
    else if (c < 4 + d_view)
      v = pe_value(dr + r * 4, 3, c - 4);
    else if (c < 8 + d_view)
      v = gs[r * 4 + (c - 4 - d_view)];
    cin[r * cg.k0 + cg.d_feat + c] = v;
  }
  if (kStaged) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * cg.k0; i += kThreads) {
      const int r = i / cg.k0;
      put_ci(0, r, i - r * cg.k0, cin[i]);
    }
  }
  for (int l = 0; l < cg.n_lin - 1; ++l) {
    const float* bc = P + off.bc[l];
    G::template run<KS>(l == 0 ? cin : h, l == 0 ? cg.k0 : ld, l == 0 ? cg.k0 : cg.hidden,
             G::wc(P, off, l), cg.hidden, cg.hidden, w_s, [&](int r, int c, float z) {
               const float v = fmaxf(z + bc[c], 0.0f);
               h[r * ld + c] = v;
               put_ci(l + 1, r, c, v);
             },
             layer_hook(pre, l));
  }
  __syncthreads();
  const float* bl = P + off.bc[cg.n_lin - 1];
  rowdot(h, ld, cg.hidden, P + off.wc[cg.n_lin - 1], 3, 3, [&](int r, int c, float v) {
    v += bl[c];
    head(r, c, cg.squeeze ? 1.0f / (1.0f + expf(-v)) : v);
  });
}

// The first-order backward of color_forward (color_kernels.py :140-156). cs
// holds each row's color (4 per row) and must be visible to every thread; h
// must still hold the last hidden layer's output. cs becomes the head's zbar
// = cbar c (1 - c) (`cbar_at(r, j)`, 0 past the last row), which goes down
// the ReLU layers: the layer-l cotangent of the input is masked by the sign
// of color layer l's input (`in_at(l, r, c)`). `put_cz(l, r, c, v)` sees the
// output cotangent of every color layer, and `pre(l)` runs in the (first)
// GEMM that reads layer l's from h (l < n_lin - 1). h0_bar (k0 wide, the
// kernel's input order) ends in cin after a GEMM epilogue. The head's
// product stays a 3-term FFMA loop on the plain W^T (off.wct) with every
// policy.
template <int KS, class G, class Cbar, class In, class PutCz, class Pre = NoHook>
__device__ __forceinline__ void color_backward(const float* __restrict__ P, const Offsets& off,
                                               const ColorGeom& cg, float* cin, float* h,
                                               float* cs, float* w_s, Cbar cbar_at, In in_at,
                                               PutCz put_cz, Pre pre = {}) {
  constexpr int ld = G::kLd;
  for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
    const int r = i >> 2, j = i & 3;
    float v = 0.0f;
    if (j < 3) {
      const float cb = cbar_at(r, j);
      v = cg.squeeze ? cb * cs[i] * (1.0f - cs[i]) : cb;
      put_cz(cg.n_lin - 1, r, j, v);
    }
    cs[i] = v;
  }
  __syncthreads();
  {
    // zbar of the last hidden layer: (zbar_head @ W_head) * (in > 0); h
    // still holds that layer's output (the head's input).
    const float* wl = P + off.wct[cg.n_lin - 1];  // (3, hidden)
    for (int i = threadIdx.x; i < kRows * cg.hidden; i += kThreads) {
      const int r = i / cg.hidden, c = i - r * cg.hidden;
      float t = 0.0f;
      for (int k = 0; k < 3; ++k) t = fmaf(cs[r * 4 + k], wl[k * cg.hidden + c], t);
      const float v = h[r * ld + c] > 0.0f ? t : 0.0f;
      h[r * ld + c] = v;
      put_cz(cg.n_lin - 2, r, c, v);
    }
  }
  for (int l = cg.n_lin - 2; l >= 1; --l) {
    G::template run<KS>(h, ld, cg.hidden, G::wct(P, off, l), cg.hidden, cg.hidden, w_s,
             [&](int r, int c, float v) {
               v = in_at(l, r, c) > 0.0f ? v : 0.0f;
               h[r * ld + c] = v;
               put_cz(l - 1, r, c, v);
             },
             layer_hook(pre, l));
  }
  // h0_bar into cin, in passes of at most 256 columns.
  G::template run<KS>(h, ld, cg.hidden, G::wct(P, off, 0), cg.k0,
           cg.k0 < kSliceCols ? cg.k0 : kSliceCols, w_s,
           [&](int r, int c, float v) { cin[r * cg.k0 + c] = v; }, layer_hook(pre, 0));
  if (cg.k0 > kSliceCols)
    G::template run<KS>(h, ld, cg.hidden, G::wct0_tail(P, off), cg.k0, cg.k0 - kSliceCols, w_s,
             [&](int r, int c, float v) { cin[r * cg.k0 + kSliceCols + c] = v; });
}

}  // namespace copenerf
