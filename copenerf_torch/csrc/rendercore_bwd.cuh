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
// bytes of rows in and out. f32 FFMA throughout, as K1-fwd.
// Design: K1-fwd's tile (64 rows, 256 threads, one 64 x 256 activation
// buffer every GEMM overwrites in place, 32-deep weight slices) with the
// 64 x 292 color-input buffer reused as the channel-B buffer of the
// down-sweep. The per-layer sigmoids and zB go to a per-block scratch in
// device memory (persistent grid). Every matrix the weight gradients need
// (T_l, z_A + z_B, u_l, p_l, color inputs and zbar: ~43 KB a row) is staged
// per row in device memory and reduced by wgrad.cu's deterministic
// split-row GEMM; rows past n are never staged, so the ragged tail adds
// nothing. The sweeps are mlp_tile.cuh's, shared with K4-bwd
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
// and ~17 KB a row more of staged rows (~61 KB in all).
#pragma once

#include "mlp_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 32;

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

template <bool kCons>
__global__ void __launch_bounds__(kThreads, 1)
rendercore_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                      const float* __restrict__ y, const float* __restrict__ sbar,
                      const float* __restrict__ gbar, const float* __restrict__ cbar,
                      const float* __restrict__ swbar, float* __restrict__ xbar,
                      float* __restrict__ dbar, float* __restrict__ ybar,
                      const float* __restrict__ P, Offsets off, float* __restrict__ scratch,
                      long long n, SdfGeom g, ColorGeom cg, RcStages st) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // activations / channel A, stride 256
  float* cin = h + kRows * kSliceCols;         // color input / h0_bar, stride k0;
  float* hb = cin;                             //   channel B of the down-sweep, stride 256
  float* e = cin + kRows * max(cg.k0, 256);    // PE; ee; J_pe gbar; e_hat
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
  float* sig_s = scratch + (long long)blockIdx.x * 2 * n_hidden * layer_floats;
  float* zb_s = sig_s + n_hidden * layer_floats;
  const long long tiles = (n + kRows - 1) / kRows;
  const int o_x = cg.d_feat;  // kernel color-input columns
  const int o_d = o_x + 4;
  const int o_g = o_d + 3 * (1 + 2 * cg.multires);
  auto sig_at = [&](int l, int r, int c) { return sig_s[l * layer_floats + r * 256 + c]; };
  auto zb_at = [&](int l, int r, int c) -> float& { return zb_s[l * layer_floats + r * 256 + c]; };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
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
    for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {  // as e was written
      const int r = i / g.d0;
      stage_put(st.t, 0, row0 + r, n, i - r * g.d0, e[i]);
    }

    // ---- SDF forward: inputs to the stage, sigmoids to the scratch ----
    sdf_hidden_forward<kSliceK>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) { sig_s[l * layer_floats + r * 256 + c] = sig; },
        [&](int l, int r, int c, float v) { stage_put(st.t, l, row0 + r, n, c, v); });
    {
      const float* bf = P + off.b_feat;
      gemm<kSliceK>(h, 256, g.hidden, P + off.w_feat, cg.d_feat, cg.d_feat, w_s,
                    [&](int r, int c, float z) { cin[r * cg.k0 + c] = z + bf[c]; });
    }

    // ---- input-gradient sweep: u_l = r_{l+1} * sig_l, staged ----
    sdf_grad_sweep<kSliceK>(P, off, g, h, e, w_s, 0, sig_at, [&](int l, int r, int c, float u) {
      stage_put(st.u, l, row0 + r, n, c, u);
    });
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      gs[i] = pe4_jac_t(h + r * 256, xs + r * 4, g.multires, j);
    }
    __syncthreads();

    // ---- color forward on [feature, x, PE(dirs), grad, 0], inputs staged ----
    color_forward<kSliceK, true>(
        P, off, cg, cin, h, w_s, xr, dr, gs,
        [&](int l, int r, int c, float v) { stage_put(st.ci, l, row0 + r, n, c, v); },
        [&](int r, int c, float v) { cs[r * 4 + c] = v; });
    __syncthreads();

    // ---- color backward: h0_bar into cin ----
    color_backward<kSliceK>(
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
      xc[i] = cin[r * cg.k0 + o_x + j];
      gs[i] = (gr < n ? gbar[gr * 4 + j] : 0.0f) + cin[r * cg.k0 + o_g + j];
      if (j < 3 && gr < n)
        dbar[gr * 3 + j] = pe3_jac_t(cin + r * cg.k0 + o_d, dr + r * 4, cg.multires, j);
    }
    __syncthreads();

    // ---- channel B up-sweep from J_pe (gbar + grad_bar_c) ----
    sdf_channel_b_up<kSliceK>(
        P, off, g, h, e, w_s, gs, xs, sig_at,
        [&](int l, int r, int c) { return stage_get(st.u, l, row0 + r, n, c); }, zb_at,
        [&](int l, int r, int c, float v) {
          if (l == n_hidden)
            stage_put(st.rh, 0, row0 + r, n, c, v);
          else
            stage_put(st.p, l, row0 + r, n, c, v);
        });

    // ---- z_A = [sbar / scale, feat_bar], z_B = 0, down channels A and B ----
    sdf_down_sweep_ab<kSliceK>(
        P, off, g, cg.d_feat, h, hb, e, w_s, sb, cin, cg.k0, sig_at, zb_at,
        [&](int l, int r, int c, float v) { stage_put(st.z, l, row0 + r, n, c, v); });
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      if (gr < n)
        xbar[gr * 4 + j] = pe4_jac_t(h + r * 256, xs + r * 4, g.multires, j) * g.scale + xc[i];
    }

    if constexpr (kCons) {
      // ---- the consistency query's backward at y (K3-bwd), staged at n + gr ----
      const long long n2 = 2 * n;
      __syncthreads();  // the x tile's readers of h and xs are done
      for (int i = threadIdx.x; i < kRows; i += kThreads)
        sb[i] = row0 + i < n ? swbar[row0 + i] / g.scale : 0.0f;
      load_and_encode(y, n, row0, g, xs, e);
      for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {  // as e was written
        const int r = i / g.d0;
        stage_put(st.t, 0, n + row0 + r, n2, i - r * g.d0, e[i]);
      }
      sdf_hidden_forward<kSliceK>(
          P, off, g, e, h, w_s,
          [&](int l, int r, int c, float sig) { sig_s[l * layer_floats + r * 256 + c] = sig; },
          [&](int l, int r, int c, float v) { stage_put(st.t, l, n + row0 + r, n2, c, v); });
      __syncthreads();
      {
        // z_head = [swbar / scale, 0 ...]: the feature columns of the last
        // layer's z rows are zero, so its reduction adds column 0 alone.
        const float* w0 = P + off.w_last0;
        const int lh = n_hidden - 1;
        const int d_head = 1 + cg.d_feat;
        for (int i = threadIdx.x; i < kRows * d_head; i += kThreads) {
          const int r = i / d_head, c = i - r * d_head;
          stage_put(st.z, n_hidden, n + row0 + r, n2, c, c == 0 ? sb[r] : 0.0f);
        }
        for (int i = threadIdx.x; i < kRows * g.hidden; i += kThreads) {
          const int r = i / g.hidden, c = i - r * g.hidden;
          h[r * 256 + c] = sb[r] * w0[c] * sig_at(lh, r, c);
        }
      }
      sdf_down_sweep_a<kSliceK>(P, off, g, h, e, w_s, sig_at, [&](int l, int r, int c, float v) {
        stage_put(st.z, l, n + row0 + r, n2, c, v);
      });
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
        const int r = i >> 2, j = i & 3;
        const long long gr = row0 + r;
        if (gr < n) ybar[gr * 4 + j] = pe4_jac_t(h + r * 256, xs + r * 4, g.multires, j) * g.scale;
      }
    }
  }
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

size_t rc_bwd_smem(int d0, int k0) {
  return sizeof(float) * (kRows * kSliceCols + kRows * (k0 > 256 ? k0 : 256) + kRows * d0 + 7 * kRows * 4 +
                          2 * kSliceK * kSliceCols);
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
               float* dbar, float* ybar, const float* params, const long long* off_w,
               const long long* off_b, const long long* off_wt, long long off_w_last0,
               long long off_b_last0, long long off_w_feat, long long off_b_feat,
               long long off_w_feat_t, const long long* off_wc, const long long* off_bc,
               const long long* off_wct, float* grads, const long long* off_gw,
               const long long* off_gb, long long off_gw_last0, const long long* off_gwc,
               const long long* off_gbc, float* stage, float* partial, float* scratch,
               long long n, int n_lin, int d_in, int multires, int hidden, int skip,
               float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0,
               int squeeze, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  SdfGeom g;
  ColorGeom cg;
  if (!rc_geometry(n, n_lin, d_in, multires, hidden, skip, scale, d_feat, c_n_lin, c_hidden,
                   c_multires, c_k0, squeeze, g, cg))
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_w, off_b, off_wt, off_w_last0, off_b_last0, off_w_feat,
                    off_b_feat, c_n_lin, off_wc, off_bc))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < c_n_lin; ++l) off.wct[l] = off_wct[l];
  off.w_feat_t = off_w_feat_t;
  const long long n_tz = kCons ? 2 * n : n;
  RcStages st;
  rc_stage_layout(g, cg, n, n_tz, stage, st);
  const size_t smem = rc_bwd_smem(g.d0, cg.k0);
  cudaError_t err = cudaFuncSetAttribute(
      rendercore_bwd_kernel<kCons>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  rendercore_bwd_kernel<kCons><<<grid, kThreads, smem, s>>>(x, dirs, y, sbar, gbar, cbar, swbar,
                                                             xbar, dbar, ybar, params, off,
                                                             scratch, n, g, cg, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = rc_jobs(g, cg, st, kCons ? n : 0, grads, off_gw, off_gb, off_gw_last0,
                             off_gwc, off_gbc, jobs);
  return (int)wgrad_launch(jobs, n_jobs, n_tz, partial, s);
}

}  // namespace
}  // namespace copenerf
