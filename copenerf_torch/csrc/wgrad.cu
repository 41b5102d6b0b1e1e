// The row-reduction GEMM of the backward kernels' weight gradients
// (declarations and design in wgrad.cuh).
//
// Pass 1 tiles each job's (O, I) output into 64 x 64 blocks; 256 threads
// each hold a 4 x 4 register block, and the rows stream through shared
// memory 16 at a time (one Z slice and one T slice of 16 x 64). A split
// covers kRowsPerSplit rows, and the blocks of one (job, split) are adjacent
// in the grid, so the slices they share are read from L2. 1024-row splits
// keep each sequential f32 sum short at no cost in time (4096-row splits
// were no faster; a two-level sum inside the split was slower), for ~3.2 KB
// of partial sums per row of K1-bwd.
#include "wgrad.cuh"

namespace copenerf {
namespace {

constexpr int kTile = 64;
constexpr int kSliceRows = 16;
constexpr int kRowsPerSplit = 1024;
constexpr int kThreadsW = 256;

struct WgradArgs {
  int n_jobs;
  int splits;
  long long n;
  WgradJob job[kMaxWgradJobs];
  int block0[kMaxWgradJobs + 1];      // first grid block of each job
  long long part0[kMaxWgradJobs];     // first partial float of each job
};

__host__ __device__ inline int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// Floats of one split of a job: the (O, I) sums, then the O bias sums.
__host__ __device__ inline long long job_floats(const WgradJob& j) {
  return (long long)j.O * j.I + j.O;
}

__global__ void __launch_bounds__(kThreadsW)
wgrad_partial_kernel(const WgradArgs a, float* __restrict__ partial) {
  __shared__ __align__(16) float zs[kSliceRows][kTile];
  __shared__ __align__(16) float ts[kSliceRows][kTile];
  int j = 0;
  while ((int)blockIdx.x >= a.block0[j + 1]) ++j;
  const WgradJob& job = a.job[j];
  const int tiles_i = cdiv(job.I, kTile);
  const int n_tiles = cdiv(job.O, kTile) * tiles_i;
  const int local = (int)blockIdx.x - a.block0[j];
  const int split = local / n_tiles;
  const int tile = local - split * n_tiles;
  const int o0 = (tile / tiles_i) * kTile;
  const int i0 = (tile % tiles_i) * kTile;
  const long long r_begin = (long long)split * kRowsPerSplit;
  const long long r_end = r_begin + kRowsPerSplit < a.n ? r_begin + kRowsPerSplit : a.n;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool bias = job.b_out != nullptr && i0 == 0 && tx == 0;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};

  for (int p = 0; p < job.n_pairs; ++p) {
    const WgradPair pr = job.p[p];
    const long long p_end = pr.rows > 0 && pr.rows < r_end ? pr.rows : r_end;
    for (long long r0 = r_begin; r0 < p_end; r0 += kSliceRows) {
      __syncthreads();  // the previous slice is consumed
      for (int idx = threadIdx.x; idx < kSliceRows * kTile; idx += kThreadsW) {
        const int kk = idx / kTile;
        const int c = idx - kk * kTile;
        const long long r = r0 + kk;
        const bool rok = r < p_end;
        const int o = o0 + c;
        const int i = i0 + c;
        float zv = 0.0f;
        if (rok && o < job.O) zv = pr.z ? pr.z[r * pr.ldz + o] : 1.0f;
        zs[kk][c] = zv;
        ts[kk][c] = (rok && i < job.I) ? pr.t[r * pr.ldt + i] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSliceRows; ++k) {
        const float4 zv = *reinterpret_cast<const float4*>(&zs[k][ty * 4]);
        const float4 tv = *reinterpret_cast<const float4*>(&ts[k][tx * 4]);
        const float zz[4] = {zv.x, zv.y, zv.z, zv.w};
        const float tt[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(zz[u], tt[v], acc[u][v]);
        if (bias && p == 0)
#pragma unroll
          for (int u = 0; u < 4; ++u) bsum[u] += zz[u];
      }
    }
  }

  float* out = partial + a.part0[j] + (long long)split * job_floats(job);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int o = o0 + ty * 4 + u;
    if (o >= job.O) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + tx * 4 + v;
      if (i < job.I) out[(long long)o * job.I + i] = acc[u][v];
    }
    if (bias) out[(long long)job.O * job.I + o] = bsum[u];
  }
}

// out = sum over splits, in split order; blockIdx.y is the job.
__global__ void __launch_bounds__(kThreadsW)
wgrad_final_kernel(const WgradArgs a, const float* __restrict__ partial) {
  const WgradJob& job = a.job[blockIdx.y];
  const long long per = job_floats(job);
  const long long e = (long long)blockIdx.x * kThreadsW + threadIdx.x;
  if (e >= per) return;
  const long long wn = (long long)job.O * job.I;
  if (e >= wn && job.b_out == nullptr) return;
  const float* src = partial + a.part0[blockIdx.y] + e;
  float s = 0.0f;
  for (int k = 0; k < a.splits; ++k) s += src[(long long)k * per];
  if (e < wn)
    job.w_out[e] = s;
  else
    job.b_out[e - wn] = s;
}

}  // namespace

long long wgrad_partial_floats(const WgradJob* jobs, int n_jobs, long long n) {
  long long per = 0;
  for (int j = 0; j < n_jobs; ++j) per += job_floats(jobs[j]);
  return per * cdiv(n, kRowsPerSplit);
}

cudaError_t wgrad_launch(const WgradJob* jobs, int n_jobs, long long n, float* partial,
                         cudaStream_t stream) {
  if (n <= 0 || n_jobs <= 0) return cudaSuccess;
  if (n_jobs > kMaxWgradJobs) return cudaErrorInvalidValue;
  WgradArgs a;
  a.n_jobs = n_jobs;
  a.splits = cdiv(n, kRowsPerSplit);
  a.n = n;
  a.block0[0] = 0;
  long long part = 0, max_per = 0;
  for (int j = 0; j < n_jobs; ++j) {
    a.job[j] = jobs[j];
    const int tiles = cdiv(jobs[j].O, kTile) * cdiv(jobs[j].I, kTile);
    a.block0[j + 1] = a.block0[j] + tiles * a.splits;
    a.part0[j] = part;
    part += job_floats(jobs[j]) * a.splits;
    if (job_floats(jobs[j]) > max_per) max_per = job_floats(jobs[j]);
  }
  wgrad_partial_kernel<<<a.block0[n_jobs], kThreadsW, 0, stream>>>(a, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(max_per, kThreadsW), n_jobs);
  wgrad_final_kernel<<<grid, kThreadsW, 0, stream>>>(a, partial);
  return cudaGetLastError();
}

}  // namespace copenerf
