// Weight gradients summed over rows, for the backward kernels
// (sdf_value_bwd.cu, rendercore_bwd.cu).
//
// Replaces what the TPU backward kernels do inside their bodies
// (copenerf_tpu/ops/pallas/sdf_kernels.py `_outer_acc` + the `pl.when(i > 0)`
// accumulation, :435-444; rendercore_kernels.py :273-292): on the TPU the row
// grid runs in order and each grid step adds its tile's T^T Z into
// VMEM-resident W-bar blocks. On Hopper the blocks run in parallel and one
// 256 x 256 f32 accumulator (256 KB) does not fit a block's shared memory, so
// the backward row kernels stage each layer's input activations T and output
// cotangents Z per row in device memory, and these two passes reduce them:
//
//   1. partial: block (job, row split, 64 x 64 output tile) computes
//      sum over its rows of Z[r][o] * T[r][i] (one or two (Z, T) pairs per
//      job), and for the tiles of the first input column also sum Z[r][o] of
//      pair 0 (the bias gradient), into its own slot of a partial buffer;
//   2. final: each output element sums its split slots in split order.
//
// A pair may cover fewer rows than the launch (`rows`): the folded
// render-core backward (K6) stages its second row set (the consistency
// query at y) after the x rows of pair 0 only, so pair 0 spans 2n rows and
// the pairs of x alone stop at n.
//
// Deterministic: the order of every sum is fixed by the shapes. Against an
// autograd sum over all rows the result differs by f32 reassociation.
// Bound: operations (f32 FFMA, 2 FLOP per row and output element) or, for
// narrow layers, the bytes of the staged rows.
#pragma once

#include <cuda_runtime.h>

namespace copenerf {

constexpr int kMaxWgradJobs = 24;

struct WgradPair {
  const float* z;  // (n, >= O) with row stride ldz; nullptr: ones (O == 1)
  const float* t;  // (n, >= I) with row stride ldt
  int ldz, ldt;
  long long rows;  // rows [0, rows) of the launch's n; 0: all n
};

// out[o][i] = sum_rows sum_pairs z[r][o] * t[r][i], row-major (O, I);
// b_out[o] = sum_rows pair 0's z[r][o] when b_out is set.
struct WgradJob {
  int O, I, n_pairs;
  WgradPair p[2];
  float* w_out;
  float* b_out;
};

// Floats of the partial buffer wgrad_launch needs for these jobs and n rows.
long long wgrad_partial_floats(const WgradJob* jobs, int n_jobs, long long n);

// Both passes on `stream`; returns the first launch error.
cudaError_t wgrad_launch(const WgradJob* jobs, int n_jobs, long long n, float* partial,
                         cudaStream_t stream);

}  // namespace copenerf
