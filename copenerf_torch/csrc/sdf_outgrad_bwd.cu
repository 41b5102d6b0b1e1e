// K4-bwd — the second-order backward of the SDF output and input gradient.
//
// Replaces: copenerf_tpu/ops/pallas/sdf_kernels.py `_build` ->
// `make_bwd_kernel(second_order=True)` (launched by `call_bwd`, the backward
// of `FusedOps.outgrad`). One launch per train step of the composed path
// (131,072 rows at the reference protocol).
//
// Computes, per row, for the cotangents obar (d_out) of out = [sdf, feature]
// and gbar (4) of grad = d(sdf)/d(x, y, z, t) (K4-fwd, sdf_outgrad_fwd.cu):
//   recompute: the SDF forward (every layer's input T_l, sigmoid(100 z_l)) and
//     the input-gradient sweep down to u_0 (u_l = r_{l+1} * sigmoid);
//   channel B up-sweep, the double backprop of grad (its x-dependence is
//     severed as in the reference): p_0 = J_pe gbar, q_l = p_l W_l,
//     p_{l+1} = q_l * sig_l, zB_l = q_l * u_l * 100 * (1 - sig_l);
//   channels A and B down-sweep from z_A = [obar_0 / scale, obar_1..], z_B = 0;
//     only channel A reaches x: x_bar = J_pe^T e_hat * scale.
//   Weight gradients (wgrad.cu, from the staged rows): hidden layer l
//   sum (z_A + z_B)^T T_l + u_l^T p_l, b sum (z_A + z_B); the last layer
//   sum z_A^T T_last, its row 0 also sum p_last (`wlast_col0_bar`).
//
// Bound on an H100: operations. ~6.6 MFLOP per row at the default config
// (forward 0.92, sweep 0.89, channel B 0.92, head 0.13, down-sweep A + B
// 1.81, weight reductions 1.97) against 1,064 bytes of rows in and 16 out.
// Design: K1-bwd (rendercore_bwd.cu) without the color MLP, through the same
// shared sweeps (mlp_tile.cuh): its 64-row tile, one 64 x 272 buffer for
// channel A and one for channel B (which first holds the feature cotangent,
// read from obar); the per-layer sigmoids and zB in a per-block scratch in
// device memory (persistent grid). Every GEMM (the forward recompute, the
// input-gradient sweep, channel B's up-sweep, the head's down GEMM over
// W_feat^T and both channels of the down-sweep) runs on the wgmma 3xTF32
// core (wgmma_tile.cuh) with a one-stage ring (WgGemm1): the two buffers
// leave no room for a second 64 KB stage (221,504 bytes with one, 287,040
// with two, of 232,448), so each slice's bulk copy is exposed. T_l,
// z_A + z_B, u_l, p_l and the row-0 term (~34 KB a row) are staged per row
// in device memory and reduced on the tensor cores in 3xTF32 by wgrad.cu's
// deterministic split-row GEMM on `wgmma` (`wgrad_tc_launch`, as K1, K3,
// K5 and K7); rows past n are never staged, so the ragged tail adds
// nothing.
#include "wgmma_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

using G = WgGemm1;

// Staged per-row matrices of K4-bwd.
struct OgStages {
  StageSet t;   // SDF layer inputs T_l, l < n_lin
  StageSet z;   // z_A + z_B per SDF layer (the last: obar with obar_0 / scale)
  StageSet p;   // channel-B inputs p_l, hidden layers
  StageSet u;   // u_l = r_{l+1} * sig_l, hidden layers
  StageSet rh;  // entry 0: p after the last hidden layer (row 0 of W_last)
};

__global__ void __launch_bounds__(kThreads, 1)
sdf_outgrad_bwd_kernel(const float* __restrict__ x, const float* __restrict__ obar,
                       const float* __restrict__ gbar, float* __restrict__ xbar,
                       const float* __restrict__ P, Offsets off, float* __restrict__ scratch,
                       long long n, SdfGeom g, int d_out, OgStages st) {
  extern __shared__ float4 smem4[];
  constexpr int ld = G::kLd;
  float* h = reinterpret_cast<float*>(smem4);  // activations / channel A, stride ld
  float* hb = h + kRows * ld;                  // feature cotangent, then channel B
  float* e = hb + kRows * ld;                  // PE; ee_skip; J_pe gbar; e_hat
  float* xs = e + kRows * g.d0;                // x * scale
  float* gs = xs + kRows * 4;                  // gbar
  float* sb = gs + kRows * 4;                  // obar_0 / scale
  float* w_s = sb + kRows;
  const int n_hidden = g.n_lin - 1;
  const int d_feat = d_out - 1;
  const long long layer_floats = (long long)kRows * 256;
  float* sig_s = scratch + (long long)blockIdx.x * 2 * n_hidden * layer_floats;
  float* zb_s = sig_s + n_hidden * layer_floats;
  const long long tiles = (n + kRows - 1) / kRows;
  auto sig_at = [&](int l, int r, int c) { return sig_s[l * layer_floats + r * 256 + c]; };
  auto zb_at = [&](int l, int r, int c) -> float& { return zb_s[l * layer_floats + r * 256 + c]; };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      const bool ok = gr < n;
      gs[i] = ok ? gbar[gr * 4 + j] : 0.0f;
      if (j == 0) sb[r] = ok ? obar[gr * d_out] / g.scale : 0.0f;
    }
    for (int i = threadIdx.x; i < kRows * d_feat; i += kThreads) {
      const int r = i / d_feat, c = i - r * d_feat;
      const long long gr = row0 + r;
      hb[r * ld + c] = gr < n ? obar[gr * d_out + 1 + c] : 0.0f;
    }
    load_and_encode(x, n, row0, g, xs, e);
    for (int i = threadIdx.x; i < kRows * g.d0; i += kThreads) {  // as e was written
      const int r = i / g.d0;
      stage_put(st.t, 0, row0 + r, n, i - r * g.d0, e[i]);
    }

    // ---- SDF forward: inputs to the stage, sigmoids to the scratch ----
    sdf_hidden_forward<G::kSliceK, G>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) { sig_s[l * layer_floats + r * 256 + c] = sig; },
        [&](int l, int r, int c, float v) { stage_put(st.t, l, row0 + r, n, c, v); });

    // ---- input-gradient sweep down to u_0, staged ----
    sdf_grad_sweep<G::kSliceK, G>(P, off, g, h, e, w_s, 1, sig_at,
                                  [&](int l, int r, int c, float u) {
                                    stage_put(st.u, l, row0 + r, n, c, u);
                                  });
    __syncthreads();

    // ---- channel B up-sweep from J_pe gbar ----
    sdf_channel_b_up<G::kSliceK, G>(
        P, off, g, h, e, w_s, gs, xs, sig_at,
        [&](int l, int r, int c) { return stage_get(st.u, l, row0 + r, n, c); }, zb_at,
        [&](int l, int r, int c, float v) {
          if (l == n_hidden)
            stage_put(st.rh, 0, row0 + r, n, c, v);
          else
            stage_put(st.p, l, row0 + r, n, c, v);
        });

    // ---- z_A = [obar_0 / scale, obar_1..], z_B = 0, down channels A and B ----
    sdf_down_sweep_ab<G::kSliceK, G>(
        P, off, g, d_feat, h, hb, e, w_s, sb, hb, ld, sig_at, zb_at,
        [&](int l, int r, int c, float v) { stage_put(st.z, l, row0 + r, n, c, v); });
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      if (gr < n) xbar[gr * 4 + j] = pe4_jac_t(h + r * ld, xs + r * 4, g.multires, j) * g.scale;
    }
  }
}

// The staged matrices of OgStages; with base null only the size is
// counted. Returns the floats used.
long long og_stage_layout(const SdfGeom& g, int d_out, long long n, float* base, OgStages& st) {
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
    take(st.z, l, l == n_hidden ? d_out : sdf_out_dim(g, l));
  }
  for (int l = 0; l < n_hidden; ++l) {
    take(st.p, l, sdf_in_dim(g, l));
    take(st.u, l, sdf_out_dim(g, l));
  }
  take(st.rh, 0, g.hidden);
  return used;
}

int og_jobs(const SdfGeom& g, int d_out, const OgStages& st, float* grads,
            const long long* off_gw, const long long* off_gb, long long off_gw_last0,
            WgradJob* jobs) {
  int k = 0;
  const int n_hidden = g.n_lin - 1;
  auto out = [&](long long o) { return grads ? grads + o : nullptr; };
  for (int l = 0; l < g.n_lin; ++l) {
    WgradJob& j = jobs[k++];
    j.O = l == n_hidden ? d_out : sdf_out_dim(g, l);
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
  WgradJob& j = jobs[k++];  // row 0 of W_last: sum of p after the last hidden layer
  j.O = 1;
  j.I = g.hidden;
  j.n_pairs = 1;
  j.p[0] = WgradPair{nullptr, st.rh.p[0], 0, st.rh.ld[0]};
  j.p[1] = WgradPair{nullptr, nullptr, 0, 0};
  j.w_out = out(off_gw_last0);
  j.b_out = nullptr;
  return k;
}

size_t og_bwd_smem(const SdfGeom& g) {
  return sizeof(float) *
         (2 * kRows * G::kLd + kRows * g.d0 + 2 * kRows * 4 + kRows + G::kWsFloats);
}

bool og_geometry(long long n, int n_lin, int d_in, int multires, int hidden, int skip,
                 float scale, int d_out, SdfGeom& g) {
  g = SdfGeom{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  return d_in == 4 && d_out >= 5 && (d_out - 1) % 4 == 0 && d_out - 1 <= kSliceCols &&
         n_lin >= 2 && n_lin - 1 <= kMaxSdfHidden && n_lin + 1 <= kMaxWgradJobs && n >= 0;
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// Device floats the backward needs beside its inputs and outputs:
// out[0] staged rows, out[1] the reduction's partial sums, out[2] the
// per-block scratch (sigmoids and channel-B injections) of n_blocks blocks.
extern "C" int copenerf_sdf_outgrad_bwd_workspace(long long n, int n_lin, int d_in, int multires,
                                                  int hidden, int skip, int d_out, int n_blocks,
                                                  long long* out) {
  SdfGeom g;
  if (!og_geometry(n, n_lin, d_in, multires, hidden, skip, 1.0f, d_out, g))
    return (int)cudaErrorInvalidValue;
  OgStages st;
  out[0] = og_stage_layout(g, d_out, n, nullptr, st);
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = og_jobs(g, d_out, st, nullptr, nullptr, nullptr, 0, jobs);
  out[1] = wgrad_partial_floats(jobs, n_jobs, n);
  out[2] = (long long)n_blocks * 2 * (n_lin - 1) * kRows * 256;
  return 0;
}

// x_bar (n, 4) and the SDF net's weight gradients (into `grads` at off_gw /
// off_gb per layer and off_gw_last0, pack.py `outgrad_grad_layout`) for the
// cotangents obar (n, d_out) and gbar (n, 4) of K4-fwd's outputs at x (n, 4).
// The weight offsets are K4-fwd's (b, W and W^T as wgmma B per hidden
// layer, the last layer's column 0 and its bias) plus wftp, the feature
// columns' transpose as wgmma B (pack.py `wg_pack_b`). Returns the first
// CUDA error.
extern "C" int copenerf_sdf_outgrad_bwd(
    const float* x, const float* obar, const float* gbar, float* xbar, const float* params,
    const long long* off_b, const long long* off_wp, const long long* off_wtp,
    long long off_w_last0, long long off_b_last0, long long off_wftp, float* grads,
    const long long* off_gw, const long long* off_gb, long long off_gw_last0, float* stage,
    float* partial, float* scratch, long long n, int n_lin, int d_in, int multires, int hidden,
    int skip, float scale, int d_out, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  SdfGeom g;
  if (!og_geometry(n, n_lin, d_in, multires, hidden, skip, scale, d_out, g))
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_b, off_wp, off_wtp, off_w_last0, off_b_last0, 0))
    return (int)cudaErrorInvalidValue;
  off.wftp = off_wftp;
  OgStages st;
  og_stage_layout(g, d_out, n, stage, st);
  const size_t smem = og_bwd_smem(g);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_outgrad_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  sdf_outgrad_bwd_kernel<<<grid, kThreads, smem, s>>>(x, obar, gbar, xbar, params, off, scratch,
                                                       n, g, d_out, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  WgradJob jobs[kMaxWgradJobs];
  const int n_jobs = og_jobs(g, d_out, st, grads, off_gw, off_gb, off_gw_last0, jobs);
  return (int)wgrad_tc_launch(jobs, n_jobs, n, partial, s);
}
