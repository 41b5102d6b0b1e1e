// The row-reduction GEMM of the backward kernels' weight gradients
// (declarations and design in wgrad.cuh).
//
// Pass 1 of `wgrad_launch` (the FFMA control of the accuracy trial) tiles
// each job's (O, I) output into 64 x 64 blocks; 256 threads each hold a
// 4 x 4 register block, and the rows stream through shared memory 16 at a
// time (one Z slice and one T slice of 16 x 64).
//
// Pass 1 of `wgrad_tc_launch`, which every backward kernel (K1, K3-K7)
// runs, is `wgrad_wg_partial_kernel`: each block a 128 x 128 output tile
// (O rows o0 .., I columns i0 ..) summed in 3xTF32 on `wgmma` m64n128k8,
// the two warpgroups owning 64 O rows each. The product is Z^T T with the
// rows as its K, and both staged matrices are row-major (n, width), so
// neither is K-major as `wgmma` takes tf32 operands:
//  * A = Z^T comes from registers, read straight from the row-major Z
//    slice: lane (g, t) of warp q takes rows t and t + 4 of a k8 step at
//    columns 16 q + g and 16 q + g + 8, split into TF32 hi and lo as it
//    loads (slice rows of kWgStride = 136 floats, 8 mod 32 banks: the 32
//    lanes hit 32 banks);
//  * B = T is transposed into the core's K-major 128-byte swizzle
//    (wgmma_tile.cuh: row n of 32 floats holds T[0..32)[n], its 16-byte
//    chunk c at c ^ (n % 8)) by a pass of all threads, which splits each
//    value into a hi and a lo buffer as it goes: a thread reads 4 rows of
//    one column (a warp: 32 neighbouring columns of one row) and writes one
//    float4 to each (8 lanes of a phase: 8 rows' distinct chunks), then
//    `fence.proxy.async` makes the writes visible to the tensor cores.
// Rows stream 32 at a time (the core's kWgSliceK) through four cp.async
// stages of raw Z and T (zeros past the pair's rows, past O and past I),
// each slice's copy issued three slices ahead, and the pairs' slices run
// as one sequence. The products of a slice go out as two groups
// (`wg_group`, the core's accuracy rule: kWgGroup k8 steps into a zeroed
// partial, added to the f32 sum by FADD); while the first runs, the
// threads split the next slice's T into the other of two B buffers and
// load the rest of this slice's A, while the second runs the first half of
// the next slice's A. One block barrier a slice: after it the next split
// and the slice after it are visible, and every product of this slice is
// done with its B buffer. Nothing that depends on the thread branches while
// products are in flight, or ptxas serializes them: every warpgroup
// multiplies (one past O, the heads' O = 1 and 3, multiplies zero rows and
// stores nothing), and the copy and split loops have fixed counts. One B
// buffer with the split between two barriers measured 1.41x this kernel's
// time, and the pipeline with such branches no faster than that (PERF.md
// §6). The bias sums of pair 0 stay f32 adds in slice order, after the
// slice's products. 1024-row splits as the FFMA pass; 205,824 bytes of
// shared memory, one block an SM.
// Neither kernel reads a column past O or I, so the staged rows' padding
// (which may hold anything) never reaches a sum.
#include "wgmma_tile.cuh"
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

constexpr int kWgTile = 128;                        // output tile: 128 O x 128 I
constexpr int kWgRows = kWgSliceK;                  // rows a slice: the core's K depth
constexpr int kWgStride = 136;                      // floats per raw slice row
constexpr int kWgRawFloats = kWgRows * kWgStride;   // one raw Z or T slice
constexpr int kWgBFloats = kWgTile * kWgRows;       // one part (hi or lo) of B
constexpr int kWgStages = 4;                        // raw (Z, T) slices in shared memory
// Two B buffers of (hi, lo), 1024-aligned, then the raw stages.
constexpr size_t kWgSmem =
    (4 * kWgBFloats + 2 * kWgStages * kWgRawFloats) * sizeof(float) + 1024;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Start the copy of rows [r0, r0 + 32) of a pair into one stage: Z columns
// [o0, o0 + 128) (ones for o < O when z is null), T columns [i0, i0 + 128),
// zeros past the pair's rows and past O and I; one cp.async group. Every
// loop has a fixed count and every branch is the block's, so the code can
// run while this warpgroup's products are in flight (ptxas serializes
// `wgmma` across a path that may diverge).
__device__ __forceinline__ void wg_load_rows(const WgradPair& pr, int O, int I, long long r0,
                                             long long p_end, int o0, int i0, float* zs,
                                             float* ts) {
  constexpr int chunks = kWgTile / 4;                  // 16-byte chunks a slice row
  constexpr int per = kWgRows * chunks / kThreadsW;    // chunks a thread, Z or T
#pragma unroll
  for (int it = 0; it < 2 * per; ++it) {
    const bool tee = it >= per;
    const int idx = (int)threadIdx.x + kThreadsW * (it % per);
    const int kk = idx / chunks;
    const int c = (idx % chunks) * 4;
    const long long r = r0 + kk;
    const bool rok = r < p_end;
    float* dst = (tee ? ts : zs) + kk * kWgStride + c;
    if (!tee && pr.z == nullptr) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = rok && o0 + c + q < O ? 1.0f : 0.0f;
      continue;
    }
    const int col = (tee ? i0 : o0) + c;
    const int left = rok ? (tee ? I : O) - col : 0;
    const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
    const float* base = tee ? pr.t : pr.z;
    const float* src = base + r * (tee ? pr.ldt : pr.ldz) + col;
    cp_async_zfill(dst, bytes > 0 ? src : base, bytes);
  }
  cp_async_commit();
}

// B = the raw T slice ts, K-major in the 128-byte swizzle, split into TF32
// hi (bh) and lo (bl) parts; then the fence that shows it to wgmma. A
// fixed count, no branch (see wg_load_rows).
__device__ __forceinline__ void wg_split_b(const float* ts, float* bh, float* bl) {
  constexpr int per = kWgTile * (kWgRows / 4) / kThreadsW;  // units a thread
  const int n = (int)threadIdx.x % kWgTile;                 // its column
#pragma unroll
  for (int it = 0; it < per; ++it) {
    const int c = (int)threadIdx.x / kWgTile + (kThreadsW / kWgTile) * it;  // rows 4c ..
    float hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned h, l;
      split_tf32(ts[(4 * c + q) * kWgStride + n], h, l);
      hi[q] = __uint_as_float(h);
      lo[q] = __uint_as_float(l);
    }
    const int at = n * kWgRows + ((c ^ (n & 7)) << 2);
    *reinterpret_cast<float4*>(bh + at) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(bl + at) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  fence_proxy_async();
}

// A = Z^T of k8 steps K0, K0 + 1 from the raw Z slice zs, split: step k
// takes rows 8 k + t (its k = t) and 8 k + t + 4 (k = t + 4) at this
// thread's rows mo, mo + 8 of the tile.
template <int K0>
__device__ __forceinline__ void wg_load_a(const float* zs, int mo, int t, unsigned (&ah)[4][4],
                                          unsigned (&al)[4][4]) {
#pragma unroll
  for (int k = K0; k < K0 + 2; ++k) {
    const float* z0 = zs + (8 * k + t) * kWgStride + mo;
    split_tf32(z0[0], ah[k][0], al[k][0]);
    split_tf32(z0[8], ah[k][1], al[k][1]);
    split_tf32(z0[4 * kWgStride], ah[k][2], al[k][2]);
    split_tf32(z0[4 * kWgStride + 8], ah[k][3], al[k][3]);
  }
}

template <TcVariant V>
__global__ void __launch_bounds__(kThreadsW, 1)
wgrad_wg_partial_kernel(const WgradArgs a, float* __restrict__ partial) {
  static_assert(kWgGroup == 2, "the pipeline issues a slice as two groups of two k8 steps");
  extern __shared__ float4 smem4[];
  // B buffer b: hi at bbuf + 2 b kWgBFloats, lo after it; stage k: Z at
  // raw + 2 k kWgRawFloats, T after it.
  float* bbuf = reinterpret_cast<float*>(
      (reinterpret_cast<unsigned long long>(smem4) + 1023) & ~1023ull);
  float* raw = bbuf + 4 * kWgBFloats;
  int j = 0;
  while ((int)blockIdx.x >= a.block0[j + 1]) ++j;
  const WgradJob& job = a.job[j];
  const int tiles_i = cdiv(job.I, kWgTile);
  const int n_tiles = cdiv(job.O, kWgTile) * tiles_i;
  const int local = (int)blockIdx.x - a.block0[j];
  const int split = local / n_tiles;
  const int tile = local - split * n_tiles;
  const int o0 = (tile / tiles_i) * kWgTile;
  const int i0 = (tile % tiles_i) * kWgTile;
  const long long r_begin = (long long)split * kRowsPerSplit;
  const long long r_end = r_begin + kRowsPerSplit < a.n ? r_begin + kRowsPerSplit : a.n;
  const int tid = threadIdx.x;
  const int lane = tid & 31, q = (tid >> 5) & 3, t = lane & 3;
  const int mo = 64 * (tid >> 7) + 16 * q + (lane >> 2);  // this thread's first A row, o - o0
  const bool bias = job.b_out != nullptr && i0 == 0 && tid < kWgTile;
  unsigned long long dh[2], dl[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    dh[b] = wg_desc(bbuf + 2 * b * kWgBFloats);
    dl[b] = wg_desc(bbuf + (2 * b + 1) * kWgBFloats);
  }
  // The block's slices: pair 0's, then pair 1's.
  long long p_end[2];
  int n_sl[2] = {0, 0};
  for (int p = 0; p < job.n_pairs; ++p) {
    const WgradPair& pr = job.p[p];
    p_end[p] = pr.rows > 0 && pr.rows < r_end ? pr.rows : r_end;
    if (p_end[p] > r_begin) n_sl[p] = cdiv(p_end[p] - r_begin, kWgRows);
  }
  const int total = n_sl[0] + n_sl[1];
  auto zs_of = [&](int s) { return raw + 2 * (s % kWgStages) * kWgRawFloats; };
  // One cp.async group a slice (empty past the last), so a wait for all
  // but the newest group is a wait for the slice before it.
  auto load = [&](int s) {
    if (s >= total) {
      cp_async_commit();
      return;
    }
    const int p = s < n_sl[0] ? 0 : 1;
    const long long r0 = r_begin + (long long)(p ? s - n_sl[0] : s) * kWgRows;
    wg_load_rows(job.p[p], job.O, job.I, r0, p_end[p], o0, i0, zs_of(s),
                 zs_of(s) + kWgRawFloats);
  };
  auto split_b = [&](int s) {
    float* bh = bbuf + 2 * (s & 1) * kWgBFloats;
    wg_split_b(zs_of(s) + kWgRawFloats, bh, bh + kWgBFloats);
  };

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
  float bsum = 0.0f;
  unsigned ah[4][4], al[4][4];

  // Slice s's products overlap the copy of slice s + 3, the split of slice
  // s + 1 into the other B buffer and the A fragments of the next group.
  // One block barrier a slice: after it slice s + 1's split and slice
  // s + 2's rows are visible, and every product of slice s is done. Every
  // warpgroup issues its products (one past O multiplies zeros and stores
  // nothing), so no path between a product's issue and its wait diverges.
  if (total > 0) {
    for (int s = 0; s < kWgStages - 1; ++s) load(s);
    cp_async_wait<kWgStages - 3>();  // slices 0 and 1 landed
    __syncthreads();
    split_b(0);
    wg_load_a<0>(zs_of(0), mo, t, ah, al);
    __syncthreads();
  }
  for (int s = 0; s < total; ++s) {
    const float* zs = zs_of(s);
    wg_group<V, 0>(d, ah, al, dh[s & 1], dl[s & 1]);
    wg_load_a<2>(zs, mo, t, ah, al);
    load(s + kWgStages - 1);
    split_b(s + 1);  // past the last slice: a stage nothing reads
    wg_group_add(acc, d);
    wg_group<V, 2>(d, ah, al, dh[s & 1], dl[s & 1]);
    wg_load_a<0>(zs_of(s + 1), mo, t, ah, al);
    wg_group_add(acc, d);
    if (bias && s < n_sl[0])
      for (int k = 0; k < kWgRows; ++k) bsum += zs[k * kWgStride + tid];
    cp_async_wait<kWgStages - 3>();  // slice s + 2 landed
    __syncthreads();
  }

  float* out = partial + a.part0[j] + (long long)split * job_floats(job);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + mo + (i >= 2 ? 8 : 0);
      const int c = i0 + 8 * jj + 2 * t + (i & 1);
      if (o < job.O && c < job.I) out[(long long)o * job.I + c] = acc[4 * jj + i];
    }
  if (bias && o0 + tid < job.O) out[(long long)job.O * job.I + o0 + tid] = bsum;
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

// Pass 1 (kMode 0: the FFMA kernel, else the wgmma one in TcVariant
// kMode), then pass 2.
template <int kMode>
cudaError_t launch_passes(const WgradJob* jobs, int n_jobs, long long n, float* partial,
                          cudaStream_t stream) {
  if (n <= 0 || n_jobs <= 0) return cudaSuccess;
  if (n_jobs > kMaxWgradJobs) return cudaErrorInvalidValue;
  constexpr int tile = kMode ? kWgTile : kTile;
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
        wgrad_wg_partial_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
    if (err != cudaSuccess) return err;
    wgrad_wg_partial_kernel<V><<<a.block0[n_jobs], kThreadsW, kWgSmem, stream>>>(a, partial);
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
    case kTf32x3: return launch_passes<kTf32x3>(jobs, n_jobs, n, partial, stream);
    case kTf32x1: return launch_passes<kTf32x1>(jobs, n_jobs, n, partial, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace copenerf
