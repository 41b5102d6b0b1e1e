// K1-bwd — the render-core field query's backward, second order.
//
// Replaces: copenerf_tpu/ops/pallas/rendercore_kernels.py `_build` ->
// `bwd_kernel` (with_cons=False, launched by `call_bwd`, the backward of
// `get_fused_rendercore`). One launch per train step (131,072 rows at the
// reference protocol).
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

__global__ void __launch_bounds__(kThreads, 1)
rendercore_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                      const float* __restrict__ sbar, const float* __restrict__ gbar,
                      const float* __restrict__ cbar, float* __restrict__ xbar,
                      float* __restrict__ dbar, const float* __restrict__ P, Offsets off,
                      float* __restrict__ scratch, long long n, SdfGeom g, ColorGeom cg,
                      RcStages st) {
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
  }
}

// The staged matrices of RcStages; with base null only the size is
// counted. Returns the floats used.
long long rc_stage_layout(const SdfGeom& g, const ColorGeom& cg, long long n, float* base,
                          RcStages& st) {
  long long used = 0;
  auto take = [&](StageSet& s, int l, int width) {
    const int ld = (width + 3) & ~3;
    s.p[l] = base ? base + used : nullptr;
    s.ld[l] = ld;
    used += n * ld;
  };
  const int n_hidden = g.n_lin - 1;
  for (int l = 0; l < g.n_lin; ++l) {
    take(st.t, l, sdf_in_dim(g, l));
    take(st.z, l, l == n_hidden ? 1 + cg.d_feat : sdf_out_dim(g, l));
  }
  for (int l = 0; l < n_hidden; ++l) {
    take(st.p, l, sdf_in_dim(g, l));
    take(st.u, l, sdf_out_dim(g, l));
  }
  take(st.rh, 0, g.hidden);
  for (int l = 0; l < cg.n_lin; ++l) {
    take(st.ci, l, l == 0 ? cg.k0 : cg.hidden);
    take(st.cz, l, l == cg.n_lin - 1 ? 3 : cg.hidden);
  }
  return used;
}

int rc_jobs(const SdfGeom& g, const ColorGeom& cg, const RcStages& st, float* grads,
            const long long* off_gw, const long long* off_gb, long long off_gw_last0,
            const long long* off_gwc, const long long* off_gbc, WgradJob* jobs) {
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
      j.p[1] = WgradPair{st.u.p[l], st.p.p[l], st.u.ld[l], st.p.ld[l]};
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
    j.p[0] = WgradPair{nullptr, st.rh.p[0], 0, st.rh.ld[0]};
    j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
    j.w_out = out(off_gw_last0);
    j.b_out = nullptr;
  }
  for (int l = 0; l < cg.n_lin; ++l) {
    WgradJob& j = jobs[k++];
    j.O = l == cg.n_lin - 1 ? 3 : cg.hidden;
    j.I = l == 0 ? cg.k0 : cg.hidden;
    j.n_pairs = 1;
    j.p[0] = WgradPair{st.cz.p[l], st.ci.p[l], st.cz.ld[l], st.ci.ld[l]};
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

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// Device floats the backward needs beside its inputs and outputs:
// out[0] staged rows, out[1] the reduction's partial sums, out[2] the
// per-block scratch (sigmoids and channel-B injections) of n_blocks blocks.
extern "C" int copenerf_rendercore_bwd_workspace(long long n, int n_lin, int d_in, int multires,
                                                 int hidden, int skip, int d_feat, int c_n_lin,
                                                 int c_hidden, int c_multires, int c_k0,
                                                 int n_blocks, long long* out) {
  SdfGeom g;
  ColorGeom cg;
  if (!rc_geometry(n, n_lin, d_in, multires, hidden, skip, 1.0f, d_feat, c_n_lin, c_hidden,
                   c_multires, c_k0, 1, g, cg))
    return (int)cudaErrorInvalidValue;
  RcStages st;
  out[0] = rc_stage_layout(g, cg, n, nullptr, st);
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = rc_jobs(g, cg, st, nullptr, nullptr, nullptr, 0, nullptr, nullptr, jobs);
  out[1] = wgrad_partial_floats(jobs, n_jobs, n);
  out[2] = (long long)n_blocks * 2 * (n_lin - 1) * kRows * 256;
  return 0;
}

// x_bar (n, 4), dirs_bar (n, 3) and both nets' weight gradients (into
// `grads` at the off_g* offsets, pack.py `rendercore_grad_layout`) for the
// cotangents sbar (n,), gbar (n, 4), cbar (n, 3) of K1-fwd's outputs at
// x (n, 4), dirs (n, 3). The weight offsets are K1-fwd's plus wct per color
// layer and w_feat_t. Returns the first CUDA error.
extern "C" int copenerf_rendercore_bwd(
    const float* x, const float* dirs, const float* sbar, const float* gbar,
    const float* cbar, float* xbar, float* dbar, const float* params, const long long* off_w,
    const long long* off_b, const long long* off_wt, long long off_w_last0,
    long long off_b_last0, long long off_w_feat, long long off_b_feat, long long off_w_feat_t,
    const long long* off_wc, const long long* off_bc, const long long* off_wct, float* grads,
    const long long* off_gw, const long long* off_gb, long long off_gw_last0,
    const long long* off_gwc, const long long* off_gbc, float* stage, float* partial,
    float* scratch, long long n, int n_lin, int d_in, int multires, int hidden, int skip,
    float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0, int squeeze,
    int n_blocks, void* stream) {
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
  RcStages st;
  rc_stage_layout(g, cg, n, stage, st);
  const size_t smem = rc_bwd_smem(g.d0, cg.k0);
  cudaError_t err = cudaFuncSetAttribute(
      rendercore_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  rendercore_bwd_kernel<<<grid, kThreads, smem, s>>>(x, dirs, sbar, gbar, cbar, xbar, dbar,
                                                      params, off, scratch, n, g, cg, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = rc_jobs(g, cg, st, grads, off_gw, off_gb, off_gw_last0, off_gwc, off_gbc,
                             jobs);
  return (int)wgrad_launch(jobs, n_jobs, n, partial, s);
}
