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
//
// K1-bwd and K6-bwd (rendercore_bwd.cuh) reduce through
// `wgrad_tc_partial_kernel` instead: the same splits, jobs and partial
// layout, each block a 128 x 128 output tile summed on the tensor cores in
// 3xTF32 (mma_tile.cuh, `kTcVariant`). Rows stream through shared memory 32
// at a time in a two-stage cp.async pipeline, the Z and T slices row-major
// with a row stride of 136 floats (8 mod 32 banks: the four row lanes of a
// fragment hit four bank groups); A = Z^T and B = T are read into their
// fragments straight from those slices (lane (g, t) reads rows t, t + 4 of
// its columns g, g + 8), so nothing is transposed in memory. Eight warps
// own 64 x 32 of the tile each (64 accumulators a thread). The bias sums
// stay f32 adds in slice order, as in pass 1 of the FFMA kernel.
#include "mma_tile.cuh"
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

constexpr int kTcTile = 128;
constexpr int kTcSliceRows = 32;
constexpr int kTcStride = 136;  // floats per slice row in shared memory
constexpr int kTcSliceFloats = kTcSliceRows * kTcStride;
constexpr size_t kTcSmem = 4 * kTcSliceFloats * sizeof(float);  // 2 stages x (Z, T)

// Start the copy of rows [r0, r0 + 32) of a pair into one stage: Z columns
// [o0, o0 + 128) (ones for o < O when z is null), T columns [i0, i0 + 128),
// zeros past the pair's rows and past O and I; one cp.async group.
__device__ __forceinline__ void tc_load_rows(const WgradPair& pr, int O, int I, long long r0,
                                             long long p_end, int o0, int i0, float* zs,
                                             float* ts) {
  for (int idx = threadIdx.x; idx < 2 * kTcSliceRows * (kTcTile / 4); idx += kThreadsW) {
    const int which = idx / (kTcSliceRows * (kTcTile / 4));  // 0: Z, 1: T
    const int rem = idx - which * (kTcSliceRows * (kTcTile / 4));
    const int kk = rem / (kTcTile / 4);
    const int c = (rem - kk * (kTcTile / 4)) * 4;
    const long long r = r0 + kk;
    const bool rok = r < p_end;
    float* dst = (which ? ts : zs) + kk * kTcStride + c;
    if (which == 0 && pr.z == nullptr) {
      for (int q = 0; q < 4; ++q) dst[q] = rok && o0 + c + q < O ? 1.0f : 0.0f;
      continue;
    }
    const int col = (which ? i0 : o0) + c;
    const int width = which ? I : O;
    const int left = rok ? width - col : 0;
    const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
    const float* base = which ? pr.t : pr.z;
    const int ld = which ? pr.ldt : pr.ldz;
    cp_async_zfill(dst, bytes > 0 ? base + r * ld + col : base, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <TcVariant V>
__global__ void __launch_bounds__(kThreadsW)
wgrad_tc_partial_kernel(const WgradArgs a, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);  // stage s: Z at 2s, T at 2s + 1
  int j = 0;
  while ((int)blockIdx.x >= a.block0[j + 1]) ++j;
  const WgradJob& job = a.job[j];
  const int tiles_i = cdiv(job.I, kTcTile);
  const int n_tiles = cdiv(job.O, kTcTile) * tiles_i;
  const int local = (int)blockIdx.x - a.block0[j];
  const int split = local / n_tiles;
  const int tile = local - split * n_tiles;
  const int o0 = (tile / tiles_i) * kTcTile;
  const int i0 = (tile % tiles_i) * kTcTile;
  const long long r_begin = (long long)split * kRowsPerSplit;
  const long long r_end = r_begin + kRowsPerSplit < a.n ? r_begin + kRowsPerSplit : a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wo = (warp >> 2) * 64;  // this warp's 64 x 32 of the tile
  const int wi = (warp & 3) * 32;
  const bool bias = job.b_out != nullptr && i0 == 0 && (int)threadIdx.x < kTcTile;

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
  float bsum = 0.0f;

  for (int p = 0; p < job.n_pairs; ++p) {
    const WgradPair pr = job.p[p];
    const long long p_end = pr.rows > 0 && pr.rows < r_end ? pr.rows : r_end;
    if (p_end <= r_begin) continue;
    const int n_sl = cdiv(p_end - r_begin, kTcSliceRows);
    __syncthreads();  // the previous pair's last slice is consumed
    tc_load_rows(pr, job.O, job.I, r_begin, p_end, o0, i0, sm, sm + kTcSliceFloats);
    for (int s = 0; s < n_sl; ++s) {
      if (s + 1 < n_sl) {
        float* nxt = sm + ((s + 1) & 1) * 2 * kTcSliceFloats;
        tc_load_rows(pr, job.O, job.I, r_begin + (long long)(s + 1) * kTcSliceRows, p_end, o0,
                     i0, nxt, nxt + kTcSliceFloats);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // slice s visible to all
      const float* zs = sm + (s & 1) * 2 * kTcSliceFloats;
      const float* ts = zs + kTcSliceFloats;
#pragma unroll
      for (int k8 = 0; k8 < kTcSliceRows; k8 += 8) {
        const float* z0 = zs + (k8 + t) * kTcStride + wo + g;
        const float* t0 = ts + (k8 + t) * kTcStride + wi + g;
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          split_tf32(t0[8 * nt], bh[nt][0], bl[nt][0]);
          split_tf32(t0[4 * kTcStride + 8 * nt], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned ah[4], al[4];
          split_tf32(z0[16 * mt], ah[0], al[0]);
          split_tf32(z0[16 * mt + 8], ah[1], al[1]);
          split_tf32(z0[4 * kTcStride + 16 * mt], ah[2], al[2]);
          split_tf32(z0[4 * kTcStride + 16 * mt + 8], ah[3], al[3]);
          mma_f32x3<V>(acc[mt], ah, al, bh, bl);
        }
      }
      if (bias && p == 0)
        for (int k = 0; k < kTcSliceRows; ++k) bsum += zs[k * kTcStride + threadIdx.x];
      __syncthreads();  // every warp is done with this stage before refilling
    }
  }

  float* out = partial + a.part0[j] + (long long)split * job_floats(job);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o0 + wo + 16 * mt + g + (q >= 2 ? 8 : 0);
        const int i = i0 + wi + 8 * nt + 2 * t + (q & 1);
        if (o < job.O && i < job.I) out[(long long)o * job.I + i] = acc[mt][nt][q];
      }
  if (bias && o0 + (int)threadIdx.x < job.O)
    out[(long long)job.O * job.I + o0 + threadIdx.x] = bsum;
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

// Pass 1 (kMode 0: the FFMA kernel, else the tensor-core one in variant
// kMode), then pass 2.
template <int kMode>
cudaError_t launch_passes(const WgradJob* jobs, int n_jobs, long long n, float* partial,
                          cudaStream_t stream) {
  if (n <= 0 || n_jobs <= 0) return cudaSuccess;
  if (n_jobs > kMaxWgradJobs) return cudaErrorInvalidValue;
  constexpr int tile = kMode ? kTcTile : kTile;
  WgradArgs a;
  a.n_jobs = n_jobs;
  a.splits = cdiv(n, kRowsPerSplit);
  a.n = n;
  a.block0[0] = 0;
  long long part = 0, max_per = 0;
  for (int j = 0; j < n_jobs; ++j) {
    a.job[j] = jobs[j];
    const int tiles = cdiv(jobs[j].O, tile) * cdiv(jobs[j].I, tile);
    a.block0[j + 1] = a.block0[j] + tiles * a.splits;
    a.part0[j] = part;
    part += job_floats(jobs[j]) * a.splits;
    if (job_floats(jobs[j]) > max_per) max_per = job_floats(jobs[j]);
  }
  if constexpr (kMode != 0) {
    constexpr TcVariant V = (TcVariant)kMode;
    cudaError_t err = cudaFuncSetAttribute(
        wgrad_tc_partial_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
    if (err != cudaSuccess) return err;
    wgrad_tc_partial_kernel<V><<<a.block0[n_jobs], kThreadsW, kTcSmem, stream>>>(a, partial);
  } else {
    wgrad_partial_kernel<<<a.block0[n_jobs], kThreadsW, 0, stream>>>(a, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(max_per, kThreadsW), n_jobs);
  wgrad_final_kernel<<<grid, kThreadsW, 0, stream>>>(a, partial);
  return cudaGetLastError();
}

}  // namespace

long long wgrad_partial_floats(const WgradJob* jobs, int n_jobs, long long n) {
  long long per = 0;
  for (int j = 0; j < n_jobs; ++j) per += job_floats(jobs[j]);
  return per * cdiv(n, kRowsPerSplit);
}

cudaError_t wgrad_launch(const WgradJob* jobs, int n_jobs, long long n, float* partial,
                         cudaStream_t stream) {
  return launch_passes<0>(jobs, n_jobs, n, partial, stream);
}

cudaError_t wgrad_tc_launch(const WgradJob* jobs, int n_jobs, long long n, float* partial,
                            cudaStream_t stream, int variant) {
  switch (variant == 0 ? (int)kTcVariant : variant) {
    case kTf32x1: return launch_passes<kTf32x1>(jobs, n_jobs, n, partial, stream);
    case kTf32x3Acc: return launch_passes<kTf32x3Acc>(jobs, n_jobs, n, partial, stream);
    case kTf32x3: return launch_passes<kTf32x3>(jobs, n_jobs, n, partial, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace copenerf
