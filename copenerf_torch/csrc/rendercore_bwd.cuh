// The render-core backward row kernel and its reduction jobs, shared by
// K1-bwd (rendercore_bwd.cu) and K6-bwd (rendercore_cons_bwd.cu): one
// template, one instantiation in each, so the two build in parallel.
//
// K1-bwd — the render-core field query's backward, second order — and
// K6-bwd — the same with the sdf-consistency query's backward folded in.
//
// Replaces: copenerf_tpu/ops/pallas/rendercore_kernels.py `_build` ->
// `bwd_kernel` (launched by `call_bwd`): K1-bwd (with_cons=False, the
// backward of `get_fused_rendercore`) and K6-bwd (with_cons=True, including
// `_value_only_bwd`; the backward of `get_fused_rendercore_cons`). One launch
// per train step (131,072 rows at the reference protocol).
//
// Computes, per row, for the cotangents sbar (1), gbar (4), cbar (3) of
// K1-fwd's sdf, grad = d(sdf)/d(x, y, z, t) and color:
//   recompute: the SDF forward (every layer's input T_l, sigmoid(100 z_l)),
//     the feature, the input-gradient sweep (u_l = r_{l+1} * sigmoid), the
//     color MLP on [feature, x, PE(dirs), grad];
//   color backward (first order): zbar = cbar * c (1 - c), down the ReLU MLP
//     to h0_bar = [feat_bar, x_bar_c, PE(dirs)_bar, grad_bar_c];
//   channel B up-sweep (the double backprop of grad, seeded by gbar +
//     grad_bar_c; its x-dependence is severed as in the reference):
//     p_0 = J_pe (gbar + grad_bar_c), q_l = p_l W_l^T, p_{l+1} = q_l * sig_l
//     (with the PE appended / sqrt(2) at the skip), zB_l = q_l * u_l * 100 *
//     (1 - sig_l);
//   channels A and B down-sweep from z_A = [sbar / scale, feat_bar], z_B = 0:
//     z_{A,l} = (z_{A,l+1} W_{l+1}) * sig_l, z_{B,l} = (z_{B,l+1} W_{l+1}) *
//     sig_l + zB_l; only A reaches x:
//     x_bar = J_pe^T e_hat * scale + x_bar_c, dirs_bar = J_pe(dirs)^T PE_bar.
//   Weight gradients (wgrad.cu, from the staged rows): SDF hidden layer l
//   sum (z_A + z_B)^T T_l + u_l^T p_l, b sum (z_A + z_B); last layer
//   sum [sbar / scale, feat_bar]^T T_last, and its row 0 also sum p_last
//   (`wlast_col0_bar`); color layer l sum zbar_l^T in_l, b sum zbar_l.
//
// Bound on an H100: operations. ~8.2 MFLOP per row (SDF forward 0.95, feature
// 0.13, gradient sweep 0.92, color forward 0.54, color backward 0.54, channel
// B up-sweep 0.92, down-sweep A + B 1.83, weight reductions 2.4) against 60
// bytes of rows in and out: 16.5 ms at 131,072 rows at the f32 FFMA rate,
// 6.7 ms in 3xTF32 on the tensor cores (3 x FLOP / 495 TFLOP/s). Its second
// roof is the staged rows: ~43 KB a row (5.6 GB at 131,072 rows), written
// once by the row kernel and read once by the reduction, ~3.4 ms of HBM
// traffic.
// Design: K1-fwd's tile (64 rows, 256 threads, one 64 x 272 activation
// buffer every GEMM overwrites in place, 32-deep weight slices) with the
// 64 x 292 color-input buffer reused as the channel-B buffer of the
// down-sweep (row stride 272 there too). Every GEMM of the row kernel (about
// 50 a tile) runs on wgmma_tile.cuh's 3xTF32 `wgmma` core with the
// one-stage ring (G = WgGemm1, as K4-bwd and K5-bwd: the two row buffers
// leave room for one 64 KB stage), the weights packed by the host as wgmma
// B; the narrow heads stay FFMA on the plain columns. Shared memory:
// 231,488 of the 232,448 bytes at the default config (d0 52, k0 292; two
// stages would need 297,024). A one-buffer variant on the two-stage ring
// (the feature and feat_bar waiting in the block's scratch, channel B run
// after channel A and added to its staged z) measured no faster: the row
// kernel 32.1-32.3 ms against 31.8-32.1, K6-bwd's 42.7-43.3 against
// 41.4-41.6 (PERF.md §6). The per-layer sigmoids and zB go to a
// per-block scratch in device memory (persistent grid). Every matrix the
// weight gradients need (T_l, z_A + z_B, u_l, p_l, color inputs and zbar)
// is staged per row in device memory and reduced by wgrad.cu's tensor-core
// split-row GEMM (`wgrad_tc_launch`: 128 x 128 output tiles on `wgmma` in
// 3xTF32, 32-row slices through two cp.async stages, the 1,024-row splits
// summed in order); rows past n are never staged, so the ragged tail adds
// nothing. Each staged matrix is the input of one of the tile's GEMMs (T_l,
// u_l, p_l, the color layers' inputs and output cotangents) or is formed
// from shared buffers (z_l = h + hb, the heads' rows), and leaves as whole
// rows: all 256 threads copy it in float4s, a warp's store filling four
// 128-byte lines (`stage_rows`), inside the GEMM that reads it, right after
// its first barrier while its first weight slice is on its way (the `pre`
// hooks of wg_gemm and of the sweeps); the rest (the last T, the color
// head's input and zbar) after a barrier that is there anyway. Stored from
// the GEMM epilogues instead, one 4-byte store a value with its own 64-bit
// address and row check, in the accumulator's layout (8 half-used 32-byte
// sectors a warp store, ~11,000 stores a row), the row kernel took 33.2 ms
// against 28.3 at 131,072 rows on an H100 and spilled 124 / 1,280 bytes
// against 16 / 16 (PERF.md §6). Bulk copies (cp.async.bulk, shared to global) were
// not built: they need a proxy fence after every epilogue and a wait before
// each GEMM's last barrier, and cannot form z_l = h + hb. The sweeps are
// mlp_tile.cuh's, shared with K4-bwd
// (sdf_outgrad_bwd.cu: all but the color parts) and K5-bwd (color_bwd.cu:
// the color parts).
//
// K6-bwd (kCons) adds, per row of y with the cotangent swbar of sdf_w, after
// the x tile in the same block: K3-bwd's row kernel (sdf_value_bwd.cu) on
// the matching tile of y, i.e. the value forward recomputed (sigmoids into
// the same scratch), z_head = swbar / scale on column 0 of the head, the
// channel-A down-sweep to y_bar = J_pe^T e_hat * scale. Its T_l and z_l go
// to the rows [n, 2n) of the x rows' T and z stages (the last layer's z with
// zero feature columns), so the one reduction launch sums both row sets into
// the same W/b bars: pair 0 of each SDF job spans 2n rows, every other pair
// n (wgrad.cuh `rows`). ~2.75 MFLOP a row more (K3-bwd's) against 36 bytes,
// and ~17 KB a row more of staged rows (~61 KB in all), which leave in whole
// rows as the x tile's do (the y tile's last T, which no GEMM reads, between
// two barriers).
//
// K1-bwd for frozen fields (the `FrozenFields` overload of the kernel, K1
// only; the test-time pose step, whose fields take no gradient): x_bar and
// dirs_bar alone. The recompute, the color backward and channel A's
// down-sweep run as above, operation for operation, so both are the full
// kernel's bit for bit; channel B, every stage and the reduction go: ~4.0
// MFLOP a row (the full row kernel's ~5.8 less channel B's 1.84) and no
// staged bytes. The color backward's ReLU masks read the inputs of color
// layers 1 .. n_lin - 2, which wait in the block's scratch where zB was.
#pragma once

#include "wgmma_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

using G = WgGemm1;

// Staged per-row matrices of K1-bwd.
struct RcStages {
  StageSet t;   // SDF layer inputs T_l, l < n_lin
  StageSet z;   // z_A + z_B per SDF layer (the last: [sbar / scale, feat_bar])
  StageSet p;   // channel-B inputs p_l, hidden layers
  StageSet u;   // u_l = r_{l+1} * sig_l, hidden layers; p[0] of `rh` below
  StageSet ci;  // color layer inputs (layer 0 in the kernel's column order)
  StageSet cz;  // color layer output cotangents zbar_l
  StageSet rh;  // entry 0: p after the last hidden layer (row 0 of W_last)
};

// Rows [0, rows) of a tile's matrix to rows gr0 .. gr0 + rows - 1 of staged
// matrix l, whole rows of s.ld[l] floats (a multiple of 4): `at(r, c)` gives
// columns c .. c + 3 of row r from shared memory. Warp w copies rows w, w +
// kWarps, ..., its lanes neighbouring float4s of a row, so a warp's store
// fills four 128-byte lines.
template <class At>
__device__ __forceinline__ void stage_rows(const StageSet& s, int l, long long gr0, int rows,
                                           At at) {
  const int ld = s.ld[l];
  float* dst = s.p[l] + gr0 * ld;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps)
    for (int c = 4 * (threadIdx.x & 31); c < ld; c += 128)
      *reinterpret_cast<float4*>(dst + (long long)r * ld + c) = at(r, c);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The last parameter of K1-bwd's frozen-fields overload below. An overload,
// not a template argument, so that the kernel's name on a device trace
// stays `rendercore_bwd_kernel<false>`.
struct FrozenFields {};

// The row kernel of K1-bwd and K6-bwd, the body of both overloads below.
// kFrozen: K1-bwd for frozen fields (above), where y, gbar, swbar, ybar and
// st go unused and the block's scratch holds the sigmoids, then the color
// layer inputs (rc_bwd_frozen_scratch).
template <bool kCons, bool kFrozen>
__device__ __forceinline__ void rendercore_bwd_rows(
    const float* __restrict__ x, const float* __restrict__ dirs, const float* __restrict__ y,
    const float* __restrict__ sbar, const float* __restrict__ gbar,
    const float* __restrict__ cbar, const float* __restrict__ swbar, float* __restrict__ xbar,
    float* __restrict__ dbar, float* __restrict__ ybar, const float* __restrict__ P,
    const Offsets& off, float* __restrict__ scratch, long long n, const SdfGeom& g,
    const ColorGeom& cg, const RcStages& st) {
  static_assert(!(kCons && kFrozen), "the folded query has no frozen-fields kernel");
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // activations / channel A, stride kTcLd
  float* cin = h + kRows * kTcLd;              // color input / h0_bar, stride k0;
  float* hb = cin;                             //   channel B of the down-sweep, stride kTcLd
  float* e = cin + kRows * max(cg.k0, kTcLd);  // PE; ee; J_pe gbar; e_hat
  float* xs = e + kRows * g.d0;                // x * scale
  float* xr = xs + kRows * 4;                  // raw x
  float* dr = xr + kRows * 4;                  // dirs (3 used)
  float* gs = dr + kRows * 4;                  // grad, then gbar + grad_bar_c
  float* xc = gs + kRows * 4;                  // x_bar_c
  float* cs = xc + kRows * 4;                  // color, then zbar of the head
  float* sb = cs + kRows * 4;                  // sbar / scale
  float* w_s = sb + kRows * 4;
  const int n_hidden = g.n_lin - 1;
  const long long layer_floats = (long long)kRows * 256;
  float* sig_s;
  if constexpr (kFrozen)
    sig_s = scratch + (long long)blockIdx.x * (n_hidden + cg.n_lin - 2) * layer_floats;
  else
    sig_s = scratch + (long long)blockIdx.x * 2 * n_hidden * layer_floats;
  float* zb_s = sig_s + n_hidden * layer_floats;  // frozen: color inputs from layer 1
  const long long tiles = (n + kRows - 1) / kRows;
  const int o_x = cg.d_feat;  // kernel color-input columns
  const int o_d = o_x + 4;
  const int o_g = o_d + 3 * (1 + 2 * cg.multires);
  auto sig_at = [&](int l, int r, int c) { return sig_s[l * layer_floats + r * 256 + c]; };
  auto zb_at = [&](int l, int r, int c) -> float& { return zb_s[l * layer_floats + r * 256 + c]; };
  auto none = [](int, int, int, float) {};
  // The staging hooks below are empty in the frozen kernel. They stay
  // lambdas there: NoHook in their place changed its SASS (PERF.md §6).

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    const int rows = (int)min((long long)kRows, n - row0);
    // Staged matrix l of `s` from a shared buffer of row stride ld_src, to
    // the rows from gr0 on (the weight gradients' rows of this tile).
    auto stage = [&](const StageSet& s, int l, long long gr0, const float* src, int ld_src) {
      stage_rows(s, l, gr0, rows, [&](int r, int c) { return ld4(src + r * ld_src + c); });
    };
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      const bool ok = gr < n;
      xr[i] = ok ? x[gr * 4 + j] : 0.0f;
      dr[i] = (ok && j < 3) ? dirs[gr * 3 + j] : 0.0f;
      if (j == 0) sb[r] = ok ? sbar[gr] / g.scale : 0.0f;
    }
    load_and_encode(x, n, row0, g, xs, e);

    // ---- SDF forward: inputs to the stage, sigmoids to the scratch ----
    sdf_hidden_forward<G::kSliceK, G>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) { sig_s[l * layer_floats + r * 256 + c] = sig; },
        none, [&](int l) {
          if constexpr (!kFrozen) stage(st.t, l, row0, l == 0 ? e : h, l == 0 ? g.d0 : kTcLd);
        });
    {
      const float* bf = P + off.b_feat;
      G::run<G::kSliceK>(
          h, kTcLd, g.hidden, G::wf(P, off), cg.d_feat, cg.d_feat, w_s,
          [&](int r, int c, float z) { cin[r * cg.k0 + c] = z + bf[c]; },
          [&] {
            if constexpr (!kFrozen) stage(st.t, n_hidden, row0, h, kTcLd);
          });
    }

    // ---- input-gradient sweep: u_l = r_{l+1} * sig_l, staged ----
    sdf_grad_sweep<G::kSliceK, G>(P, off, g, h, e, w_s, 0, sig_at, none,
                                  [&](int l) {
                                    if constexpr (!kFrozen) stage(st.u, l, row0, h, kTcLd);
                                  });
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      gs[i] = pe4_jac_t(h + r * kTcLd, xs + r * 4, g.multires, j);
    }
    __syncthreads();

    // ---- color forward on [feature, x, PE(dirs), grad, 0], inputs staged ----
    color_forward<G::kSliceK, false, G>(
        P, off, cg, cin, h, w_s, xr, dr, gs,
        [&](int l, int r, int c, float v) {
          if constexpr (kFrozen) {
            if (l < cg.n_lin - 1) zb_at(l - 1, r, c) = v;
          }
        },
        [&](int r, int c, float v) { cs[r * 4 + c] = v; },
        [&](int l) {
          if constexpr (!kFrozen) stage(st.ci, l, row0, l == 0 ? cin : h, l == 0 ? cg.k0 : kTcLd);
        });
    if constexpr (!kFrozen) stage(st.ci, cg.n_lin - 1, row0, h, kTcLd);  // the head's input
    __syncthreads();

    // ---- color backward: h0_bar into cin ----
    color_backward<G::kSliceK, G>(
        P, off, cg, cin, h, cs, w_s,
        [&](int r, int j) {
          const long long gr = row0 + r;
          return gr < n ? cbar[gr * 3 + j] : 0.0f;
        },
        [&](int l, int r, int c) -> float {
          if constexpr (kFrozen)
            return zb_at(l - 1, r, c);
          else
            return stage_get(st.ci, l, row0 + r, n, c);
        },
        none, [&](int l) {
          if constexpr (!kFrozen) stage(st.cz, l, row0, h, kTcLd);
        });
    if constexpr (!kFrozen) stage(st.cz, cg.n_lin - 1, row0, cs, 4);  // the head's zbar, 0 at 3
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      xc[i] = cin[r * cg.k0 + o_x + j];
      if constexpr (!kFrozen)
        gs[i] = (gr < n ? gbar[gr * 4 + j] : 0.0f) + cin[r * cg.k0 + o_g + j];
      if (j < 3 && gr < n)
        dbar[gr * 3 + j] = pe3_jac_t(cin + r * cg.k0 + o_d, dr + r * 4, cg.multires, j);
    }
    __syncthreads();

    if constexpr (kFrozen) {
      // ---- channel A from z_A = [sbar / scale, feat_bar], seeded as
      // sdf_down_sweep_ab seeds h, down to e_hat ----
      const float* w0 = P + off.w_last0;
      const int lh = n_hidden - 1;
      G::run<G::kSliceK>(cin, cg.k0, cg.d_feat, G::wft(P, off), g.hidden, g.hidden, w_s,
                         [&](int r, int c, float v) {
                           v = fmaf(sb[r], w0[c], v);
                           h[r * kTcLd + c] = v * sig_at(lh, r, c);
                         });
      sdf_down_sweep_a<G::kSliceK, G>(P, off, g, h, e, w_s, sig_at,
                                      [](int, int, int, float) {});
    } else {
      // ---- channel B up-sweep from J_pe (gbar + grad_bar_c) ----
      sdf_channel_b_up<G::kSliceK, G>(
          P, off, g, h, e, w_s, gs, xs, sig_at,
          [&](int l, int r, int c) { return stage_get(st.u, l, row0 + r, n, c); }, zb_at,
          none, [&](int l) { stage(st.p, l, row0, l == 0 ? e : h, l == 0 ? g.d0 : kTcLd); });

      // ---- z_A = [sbar / scale, feat_bar], z_B = 0, down channels A and B ----
      sdf_down_sweep_ab<G::kSliceK, G>(
          P, off, g, cg.d_feat, h, hb, e, w_s, sb, cin, cg.k0, sig_at, zb_at, none,
          [&](int l) {
            if (l == n_hidden) {
              // the head's z [sbar / scale, feat_bar, 0 pad], and the up-sweep's
              // last p, still in h
              const int d_head = 1 + cg.d_feat;
              stage_rows(st.z, l, row0, rows, [&](int r, int c) {
                float v[4];
                for (int j = 0; j < 4; ++j)
                  v[j] = c + j == 0 ? sb[r] : c + j < d_head ? cin[r * cg.k0 + c + j - 1] : 0.0f;
                return make_float4(v[0], v[1], v[2], v[3]);
              });
              stage(st.rh, 0, row0, h, kTcLd);
            } else {
              stage_rows(st.z, l, row0, rows, [&](int r, int c) {
                const float4 a = ld4(h + r * kTcLd + c), b = ld4(hb + r * kTcLd + c);
                return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
              });
            }
          });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      if (gr < n)
        xbar[gr * 4 + j] = pe4_jac_t(h + r * kTcLd, xs + r * 4, g.multires, j) * g.scale + xc[i];
    }

    if constexpr (kCons) {
      // ---- the consistency query's backward at y (K3-bwd), staged at n + gr ----
      __syncthreads();  // the x tile's readers of h and xs are done
      for (int i = threadIdx.x; i < kRows; i += kThreads)
        sb[i] = row0 + i < n ? swbar[row0 + i] / g.scale : 0.0f;
      load_and_encode(y, n, row0, g, xs, e);
      sdf_hidden_forward<G::kSliceK, G>(
          P, off, g, e, h, w_s,
          [&](int l, int r, int c, float sig) { sig_s[l * layer_floats + r * 256 + c] = sig; },
          none, [&](int l) { stage(st.t, l, n + row0, l == 0 ? e : h, l == 0 ? g.d0 : kTcLd); });
      __syncthreads();
      stage(st.t, n_hidden, n + row0, h, kTcLd);
      {
        // z_head = [swbar / scale, 0 ...]: the feature columns of the last
        // layer's z rows are zero, so its reduction adds column 0 alone.
        const float* w0 = P + off.w_last0;
        const int lh = n_hidden - 1;
        stage_rows(st.z, n_hidden, n + row0, rows, [&](int r, int c) {
          return make_float4(c == 0 ? sb[r] : 0.0f, 0.0f, 0.0f, 0.0f);
        });
        __syncthreads();  // the copies' reads of h are done
        for (int i = threadIdx.x; i < kRows * g.hidden; i += kThreads) {
          const int r = i / g.hidden, c = i - r * g.hidden;
          h[r * kTcLd + c] = sb[r] * w0[c] * sig_at(lh, r, c);
        }
      }
      sdf_down_sweep_a<G::kSliceK, G>(P, off, g, h, e, w_s, sig_at, none,
                                      [&](int l) { stage(st.z, l, n + row0, h, kTcLd); });
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
        const int r = i >> 2, j = i & 3;
        const long long gr = row0 + r;
        if (gr < n) ybar[gr * 4 + j] = pe4_jac_t(h + r * kTcLd, xs + r * 4, g.multires, j) * g.scale;
      }
    }
  }
}

// K1-bwd (kCons false) and K6-bwd (true): x_bar, dirs_bar (and K6's
// y_bar), the rows staged for the weight reduction.
template <bool kCons>
__global__ void __launch_bounds__(kThreads, 1)
rendercore_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                      const float* __restrict__ y, const float* __restrict__ sbar,
                      const float* __restrict__ gbar, const float* __restrict__ cbar,
                      const float* __restrict__ swbar, float* __restrict__ xbar,
                      float* __restrict__ dbar, float* __restrict__ ybar,
                      const float* __restrict__ P, Offsets off, float* __restrict__ scratch,
                      long long n, SdfGeom g, ColorGeom cg, RcStages st) {
  rendercore_bwd_rows<kCons, false>(x, dirs, y, sbar, gbar, cbar, swbar, xbar, dbar, ybar, P,
                                    off, scratch, n, g, cg, st);
}

// K1-bwd for frozen fields: x_bar and dirs_bar alone (rendercore_bwd_rows).
template <bool kCons>
__global__ void __launch_bounds__(kThreads, 1)
rendercore_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                      const float* __restrict__ sbar, const float* __restrict__ cbar,
                      float* __restrict__ xbar, float* __restrict__ dbar,
                      const float* __restrict__ P, Offsets off, float* __restrict__ scratch,
                      long long n, SdfGeom g, ColorGeom cg, FrozenFields) {
  rendercore_bwd_rows<kCons, true>(x, dirs, nullptr, sbar, nullptr, cbar, nullptr, xbar, dbar,
                                   nullptr, P, off, scratch, n, g, cg, RcStages{});
}

// The staged matrices of RcStages: the SDF layers' T and z take n_tz rows
// (2n with the folded query, whose rows follow the x rows), the others n.
// With base null only the size is counted. Returns the floats used.
long long rc_stage_layout(const SdfGeom& g, const ColorGeom& cg, long long n, long long n_tz,
                          float* base, RcStages& st) {
  long long used = 0;
  auto take = [&](StageSet& s, int l, int width, long long rows) {
    const int ld = (width + 3) & ~3;
    s.p[l] = base ? base + used : nullptr;
    s.ld[l] = ld;
    used += rows * ld;
  };
  const int n_hidden = g.n_lin - 1;
  for (int l = 0; l < g.n_lin; ++l) {
    take(st.t, l, sdf_in_dim(g, l), n_tz);
    take(st.z, l, l == n_hidden ? 1 + cg.d_feat : sdf_out_dim(g, l), n_tz);
  }
  for (int l = 0; l < n_hidden; ++l) {
    take(st.p, l, sdf_in_dim(g, l), n);
    take(st.u, l, sdf_out_dim(g, l), n);
  }
  take(st.rh, 0, g.hidden, n);
  for (int l = 0; l < cg.n_lin; ++l) {
    take(st.ci, l, l == 0 ? cg.k0 : cg.hidden, n);
    take(st.cz, l, l == cg.n_lin - 1 ? 3 : cg.hidden, n);
  }
  return used;
}

// The reduction's jobs; x_rows limits every pair but the SDF layers' (z, T)
// pair to the x rows (0: all the launch's rows, as K1-bwd has no others).
int rc_jobs(const SdfGeom& g, const ColorGeom& cg, const RcStages& st, long long x_rows,
            float* grads, const long long* off_gw, const long long* off_gb,
            long long off_gw_last0, const long long* off_gwc, const long long* off_gbc,
            WgradJob* jobs) {
  int k = 0;
  const int n_hidden = g.n_lin - 1;
  auto out = [&](long long o) { return grads ? grads + o : nullptr; };
  for (int l = 0; l < g.n_lin; ++l) {
    WgradJob& j = jobs[k++];
    j.O = l == n_hidden ? 1 + cg.d_feat : sdf_out_dim(g, l);
    j.I = sdf_in_dim(g, l);
    j.p[0] = WgradPair{st.z.p[l], st.t.p[l], st.z.ld[l], st.t.ld[l]};
    if (l < n_hidden) {
      j.n_pairs = 2;
      j.p[1] = WgradPair{st.u.p[l], st.p.p[l], st.u.ld[l], st.p.ld[l], x_rows};
    } else {
      j.n_pairs = 1;
      j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
    }
    j.w_out = out(grads ? off_gw[l] : 0);
    j.b_out = out(grads ? off_gb[l] : 0);
  }
  {
    WgradJob& j = jobs[k++];  // row 0 of W_last: sum of p after the last hidden layer
    j.O = 1;
    j.I = g.hidden;
    j.n_pairs = 1;
    j.p[0] = WgradPair{nullptr, st.rh.p[0], 0, st.rh.ld[0], x_rows};
    j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
    j.w_out = out(off_gw_last0);
    j.b_out = nullptr;
  }
  for (int l = 0; l < cg.n_lin; ++l) {
    WgradJob& j = jobs[k++];
    j.O = l == cg.n_lin - 1 ? 3 : cg.hidden;
    j.I = l == 0 ? cg.k0 : cg.hidden;
    j.n_pairs = 1;
    j.p[0] = WgradPair{st.cz.p[l], st.ci.p[l], st.cz.ld[l], st.ci.ld[l], x_rows};
    j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
    j.w_out = out(grads ? off_gwc[l] : 0);
    j.b_out = out(grads ? off_gbc[l] : 0);
  }
  return k;
}

// Shared memory of one block, in bytes: 231,488 at the default config
// (d0 52, k0 292).
size_t rc_bwd_smem(int d0, int k0) {
  return sizeof(float) * (kRows * kTcLd + kRows * (k0 > kTcLd ? k0 : kTcLd) + kRows * d0 +
                          7 * kRows * 4 + G::kWsFloats);
}

bool rc_geometry(long long n, int n_lin, int d_in, int multires, int hidden, int skip,
                 float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0,
                 int squeeze, SdfGeom& g, ColorGeom& cg) {
  g = SdfGeom{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  cg = ColorGeom{c_n_lin, c_hidden, c_multires, d_feat, c_k0, squeeze};
  return d_in == 4 && c_k0 % 4 == 0 && c_k0 <= 512 && n_lin >= 2 &&
         n_lin - 1 <= kMaxSdfHidden && c_n_lin >= 2 && c_n_lin <= kMaxColorLayers &&
         n_lin + 1 + c_n_lin <= kMaxWgradJobs && n >= 0;
}

// Floats of the staged rows, the partial sums and the scratch (out[0..2]);
// kCons doubles the rows of the SDF layers' T and z stages.
template <bool kCons>
int rc_bwd_workspace(long long n, int n_lin, int d_in, int multires, int hidden, int skip,
                     int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0,
                     int n_blocks, long long* out) {
  SdfGeom g;
  ColorGeom cg;
  if (!rc_geometry(n, n_lin, d_in, multires, hidden, skip, 1.0f, d_feat, c_n_lin, c_hidden,
                   c_multires, c_k0, 1, g, cg))
    return (int)cudaErrorInvalidValue;
  const long long n_tz = kCons ? 2 * n : n;
  RcStages st;
  out[0] = rc_stage_layout(g, cg, n, n_tz, nullptr, st);
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = rc_jobs(g, cg, st, kCons ? n : 0, nullptr, nullptr, nullptr, 0, nullptr,
                             nullptr, jobs);
  out[1] = wgrad_partial_floats(jobs, n_jobs, n_tz);
  out[2] = (long long)n_blocks * 2 * (n_lin - 1) * kRows * 256;
  return 0;
}

template <bool kCons>
int rc_bwd_run(const float* x, const float* dirs, const float* y, const float* sbar,
               const float* gbar, const float* cbar, const float* swbar, float* xbar,
               float* dbar, float* ybar, const float* params, const long long* off_b,
               const long long* off_wp, const long long* off_wtp, long long off_w_last0,
               long long off_b_last0, long long off_wfp, long long off_wftp,
               long long off_b_feat, const long long* off_wcp, const long long* off_wctp,
               long long off_wct0tp, const long long* off_bc, long long off_wc_last,
               long long off_wct_last, float* grads, const long long* off_gw,
               const long long* off_gb, long long off_gw_last0, const long long* off_gwc,
               const long long* off_gbc, float* stage, float* partial, float* scratch,
               long long n, int n_lin, int d_in, int multires, int hidden, int skip,
               float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0,
               int squeeze, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  SdfGeom g;
  ColorGeom cg;
  if (!rc_geometry(n, n_lin, d_in, multires, hidden, skip, scale, d_feat, c_n_lin, c_hidden,
                   c_multires, c_k0, squeeze, g, cg) ||
      (c_k0 > kSliceCols && off_wct0tp == 0))
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (!make_rendercore_offsets(off, n_lin - 1, off_b, off_wp, off_wtp, off_w_last0,
                               off_b_last0, off_wfp, off_wftp, off_b_feat, c_n_lin, off_wcp,
                               off_wctp, off_wct0tp, off_bc, off_wc_last, off_wct_last))
    return (int)cudaErrorInvalidValue;
  const long long n_tz = kCons ? 2 * n : n;
  RcStages st;
  rc_stage_layout(g, cg, n, n_tz, stage, st);
  using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, float*, float*, float*, const float*,
                          Offsets, float*, long long, SdfGeom, ColorGeom, RcStages);
  const Kernel kernel = rendercore_bwd_kernel<kCons>;  // not the frozen-fields overload
  const size_t smem = rc_bwd_smem(g.d0, cg.k0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, kThreads, smem, s>>>(x, dirs, y, sbar, gbar, cbar, swbar, xbar, dbar, ybar,
                                      params, off, scratch, n, g, cg, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = rc_jobs(g, cg, st, kCons ? n : 0, grads, off_gw, off_gb, off_gw_last0,
                             off_gwc, off_gbc, jobs);
  return (int)wgrad_tc_launch(jobs, n_jobs, n_tz, partial, s);
}

}  // namespace
}  // namespace copenerf
