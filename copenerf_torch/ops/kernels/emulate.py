"""Host emulation of the port's CUDA kernels, for checking them without a card.

    python -m copenerf_torch.ops.kernels.emulate [--width small|full]
        [--negative-ray] [--csrc DIR]

Each ``csrc/*.cu`` is compiled by ``g++`` as C++ against ``HEADER``, which
implements the CUDA subset the kernels use on host threads: one
``std::thread`` per CUDA thread of a block, walking the blocks of a launch
in turn,
``std::barrier`` for ``__syncthreads`` and the warp shuffles, shared memory
filled with NaN at each block's start (a read before a write shows), and
``cp.async`` as a synchronous copy (zero-filled past its source bytes).
``cvt.rna.tf32.f32`` (``tf32_split.cuh``) rounds to nearest, ties away from
zero, to 10 explicit mantissa bits. The wgmma core of ``wgmma_tile.cuh``:
``wgmma.mma_async`` m64n128k8 TF32 is a warpgroup-collective exchange of
every thread's A fragment through a per-warpgroup buffer between two
barriers of its 128 threads, each thread computing its 64 accumulators from
A and from B read out of shared memory through the matrix descriptor (start
address, leading and stride byte offsets, no swizzle or the 128-byte one),
ignoring the low 13 bits of each operand as the hardware does, the eight
products of a k8 step summed exactly and added to the accumulator with one
rounding (the card's own accumulation rounding is not modelled), computed
when issued; ``wgmma.fence``, ``commit_group``, ``wait_group`` and
``fence.proxy.async`` are no-ops; an ``mbarrier`` (init, arrive.expect_tx,
try_wait.parity, inval) is a phase, a pending count and a transaction count
under a mutex; ``cp.async.bulk`` copies at once and completes its bytes on
the barrier. Shared memory is 1024-byte aligned, as the swizzle needs. A
descriptor that disagrees across the warpgroup, a read past shared memory,
a barrier used uninitialized or a barrier wait that does not complete
within a minute makes the launch return an error. A copy
of the sources under ``_build/emulated/`` has the launch syntax and every
``asm`` rewritten. ``emulated()`` points the wrappers' ``build``
module at that library and lets the launchers take CPU tensors, so the
launchers and the autograd.Functions run as they are; ``check`` holds every
kernel against its plain version: forward outputs by their largest
absolute error, backward kernels per gradient tensor against an f64
evaluation of the plain version, beside the plain f32 version's error (the
rule of ``chip_smoke.py``).

It shows indexing and layout faults, wrong argument lists and wrong
arithmetic; it says nothing of speed, registers or what ``nvcc`` accepts.
``--csrc`` builds another copy of the sources (a planted fault, say).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import os
import re
import shutil
import subprocess
import sys

import torch

from . import build

HEADER = r"""
#pragma once
#include <algorithm>
#include <array>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstring>
#include <functional>
#include <atomic>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct HostIdx { unsigned x, y, z; };
inline thread_local HostIdx threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
typedef enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 } cudaError_t;
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline std::atomic<int> host_error{0};
inline cudaError_t cudaGetLastError() {
  return host_error.exchange(0) ? cudaErrorInvalidValue : cudaSuccess;
}
inline float __expf(float x) { return std::exp(x); }
inline float __logf(float x) { return std::log(x); }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline std::barrier<>* host_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;
inline std::vector<std::array<float, 32>> host_shuffle;
inline float4* host_shared;
inline size_t host_shared_bytes;
inline float4* host_dynamic_shared() { return host_shared; }
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const char*)p - (const char*)host_shared);
}
struct HostWgLane { unsigned a[4]; unsigned long long desc; int scale; };
// Two exchange buffers a warpgroup, used in turn (a thread's count of its
// wgmma calls picks one), so one barrier a call suffices: a buffer is
// written again only after the next call's barrier, which every reader of
// it has passed.
inline std::vector<std::array<std::array<HostWgLane, 128>, 2>> host_wg;
inline thread_local unsigned host_wg_calls;
inline std::vector<std::unique_ptr<std::barrier<>>> host_wg_barriers;
struct HostMbar { unsigned count, pending, phase; long long tx; };
inline std::mutex host_mbar_mutex;
inline std::map<const void*, HostMbar> host_mbars;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  host_shuffle[w][lane] = v;
  host_warp_barriers[w]->arrive_and_wait();
  const float r = host_shuffle[w][lane ^ o];
  host_warp_barriers[w]->arrive_and_wait();
  return r;
}
inline void host_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> fn) {
  gridDim = grid;
  blockDim = block;
  const int nt = block.x;
  std::vector<float4> shared(smem / 16 + 1 + 64);
  host_shared = reinterpret_cast<float4*>(
      (reinterpret_cast<size_t>(shared.data()) + 1023) & ~(size_t)1023);
  host_shared_bytes = (smem / 16 + 1) * 16;
  std::barrier<> bar(nt);
  host_block_barrier = &bar;
  host_warp_barriers.clear();
  for (int w = 0; w < (nt + 31) / 32; ++w)
    host_warp_barriers.emplace_back(new std::barrier<>(32));
  host_wg_barriers.clear();
  for (int w = 0; w < nt / 128; ++w) host_wg_barriers.emplace_back(new std::barrier<>(128));
  host_shuffle.assign((nt + 31) / 32, {});
  host_wg.assign(nt / 128, {});
  host_mbars.clear();
  const float nan = std::numeric_limits<float>::quiet_NaN();
  // One thread per CUDA thread for the whole launch, walking the blocks in
  // turn: thread 0 refills shared memory with NaN between two barriers.
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = {(unsigned)t, 0, 0};
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          if (t == 0)
            for (auto& f : shared) f = float4{nan, nan, nan, nan};
          bar.arrive_and_wait();
          host_wg_calls = 0;
          blockIdx = {bx, by, 0};
          fn();
          bar.arrive_and_wait();
        }
    });
  for (auto& th : threads) th.join();
}
// cvt.rna.tf32.f32: nearest, ties away from zero, 10 explicit mantissa bits.
inline unsigned host_tf32_rna(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  return u & 0xffffe000u;
}
// Element (n, k) of a K-major B operand through a wgmma matrix descriptor:
// bits 0-13 start address, 16-29 leading byte offset, 32-45 stride byte
// offset (each >> 4), 62-63 the swizzle (0 none, 1 128-byte).
inline const float* host_desc_elem(unsigned long long desc, int n, int k) {
  const size_t start = (size_t)(desc & 0x3FFF) << 4;
  const size_t lbo = (size_t)((desc >> 16) & 0x3FFF) << 4;
  const size_t sbo = (size_t)((desc >> 32) & 0x3FFF) << 4;
  const int mode = (int)(desc >> 62);
  size_t a;
  if (mode == 1) {
    a = start + (n / 8) * sbo + (n % 8) * 128 + 4 * k;
    a ^= ((a >> 7) & 7) << 4;
  } else if (mode == 0) {
    a = start + (n / 8) * sbo + (n % 8) * 16 + (k / 4) * lbo + (k % 4) * 4;
  } else {
    host_error = 1;
    return nullptr;
  }
  if (a + 4 > host_shared_bytes) {
    host_error = 1;
    return nullptr;
  }
  return reinterpret_cast<const float*>(reinterpret_cast<const char*>(host_shared) + a);
}
// wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 with A from
// registers, one warpgroup: d = a b (+ d when scale_d).
inline void host_wgmma_tf32(float (&d)[64], const unsigned (&a)[4], unsigned long long desc,
                            int scale_d) {
  const int wg = threadIdx.x / 128, me = threadIdx.x % 128;
  auto& buf = host_wg[wg][host_wg_calls++ & 1];
  HostWgLane& mine = buf[me];
  for (int i = 0; i < 4; ++i) mine.a[i] = a[i] & 0xffffe000u;
  mine.desc = desc;
  mine.scale = scale_d;
  host_wg_barriers[wg]->arrive_and_wait();
  for (int l = 0; l < 128; ++l)
    if (buf[l].desc != desc || buf[l].scale != scale_d) host_error = 1;
  const int q = me / 32, lane = me % 32, g = lane / 4, t = lane % 4;
  float out[64];
  for (int j = 0; j < 16; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * q + g + (i >= 2 ? 8 : 0), col = 8 * j + 2 * t + (i & 1);
      double s = 0.0;
      for (int k = 0; k < 8; ++k) {
        const unsigned av =
            buf[(row / 16) * 32 + (row % 8) * 4 + k % 4].a[(row % 16 >= 8) + 2 * (k >= 4)];
        const float* bp = host_desc_elem(desc, col, k);
        if (bp == nullptr) continue;
        const unsigned bv = __float_as_uint(*bp) & 0xffffe000u;
        s += (double)__uint_as_float(av) * (double)__uint_as_float(bv);
      }
      out[4 * j + i] = (float)((scale_d ? (double)d[4 * j + i] : 0.0) + s);
    }
  for (int i = 0; i < 64; ++i) d[i] = out[i];
}
inline void host_mbar_complete(HostMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.count;
  }
}
inline HostMbar* host_mbar_find(const void* bar) {
  auto it = host_mbars.find(bar);
  if (it == host_mbars.end()) {
    host_error = 1;
    return nullptr;
  }
  return &it->second;
}
inline void host_mbar_init(const void* bar, unsigned count) {
  std::lock_guard<std::mutex> lk(host_mbar_mutex);
  host_mbars[bar] = HostMbar{count, count, 0u, 0};
}
inline void host_mbar_inval(const void* bar) {
  std::lock_guard<std::mutex> lk(host_mbar_mutex);
  if (host_mbar_find(bar)) host_mbars.erase(bar);
}
inline void host_mbar_expect_tx(const void* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lk(host_mbar_mutex);
  HostMbar* b = host_mbar_find(bar);
  if (b == nullptr) return;
  if (b->pending == 0) host_error = 1;
  b->tx += bytes;
  b->pending -= 1;
  host_mbar_complete(*b);
}
// A wait that has not completed after kHostWaitSeconds (a phase that never
// comes: a refill or an arrival out of order) ends with an error instead of
// hanging the launch.
constexpr int kHostWaitSeconds = 60;
inline thread_local bool host_waiting;
inline thread_local std::chrono::steady_clock::time_point host_wait_since;
inline bool host_mbar_try_wait(const void* bar, unsigned parity) {
  bool done = true;
  {
    std::lock_guard<std::mutex> lk(host_mbar_mutex);
    HostMbar* b = host_mbar_find(bar);
    if (b != nullptr) done = b->phase != (parity & 1u);
  }
  if (done) {
    host_waiting = false;
    return true;
  }
  const auto now = std::chrono::steady_clock::now();
  if (!host_waiting) {
    host_waiting = true;
    host_wait_since = now;
  } else if (now - host_wait_since > std::chrono::seconds(kHostWaitSeconds)) {
    host_error = 1;
    host_waiting = false;
    return true;
  }
  std::this_thread::yield();
  return false;
}
// cp.async.bulk global -> shared, completing `bytes` on the barrier.
inline void host_bulk_g2s(float* dst, const float* src, unsigned bytes, const void* bar) {
  const size_t off = __cvta_generic_to_shared(dst);
  if (bytes % 16 || off % 16 || reinterpret_cast<size_t>(src) % 16 ||
      off + bytes > host_shared_bytes) {
    host_error = 1;
    return;
  }
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> lk(host_mbar_mutex);
  HostMbar* b = host_mbar_find(bar);
  if (b == nullptr) return;
  b->tx -= bytes;
  host_mbar_complete(*b);
}
#define HOST_LAUNCH(G, B, S, K, ...) host_launch(dim3(G), dim3(B), S, [&] { K(__VA_ARGS__); })
"""

_CP_ASYNC = re.compile(
    r"const unsigned dst = \(unsigned\)__cvta_generic_to_shared\(smem\);\s*"
    r"const int src_bytes = pred \? 16 : 0;\s*asm volatile\(.*?\"r\"\(src_bytes\)\);",
    re.S)
_CP_ZFILL = re.compile(
    r"const unsigned dst = \(unsigned\)__cvta_generic_to_shared\(smem\);\s*"
    r"asm volatile\(\"cp\.async\.cg\.shared\.global.*?\"r\"\(bytes\)\);",
    re.S)
_CVT_TF32 = ('asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));')
# The wgmma core (wgmma_tile.cuh): each helper's one asm statement, and
# what the host runs in its place.
_WG_ASM = [
    (re.compile(r'asm volatile\("mbarrier\.init\..*?\);', re.S),
     "host_mbar_init(bar, count);"),
    (re.compile(r'asm volatile\("mbarrier\.inval\..*?\);', re.S),
     "host_mbar_inval(bar);"),
    (re.compile(r'asm volatile\("mbarrier\.arrive\.expect_tx\..*?\);', re.S),
     "host_mbar_expect_tx(bar, bytes);"),
    (re.compile(r'asm volatile\(\s*"\{\\n\.reg \.pred p;\\nmbarrier\.try_wait\..*?\);',
                re.S), "done = host_mbar_try_wait(bar, parity);"),
    (re.compile(r'asm volatile\(\s*"cp\.async\.bulk\..*?\);', re.S),
     "host_bulk_g2s(dst, src, bytes, bar);"),
    (re.compile(r'asm volatile\("fence\.proxy\.async\..*?\);', re.S), ""),
    (re.compile(r'asm volatile\("wgmma\.(?:fence|commit_group|wait_group)\..*?\);', re.S), ""),
    (re.compile(r'asm volatile\("" : "\+f"\(v\)::"memory"\);'), ""),
    (re.compile(r'asm volatile\(\s*"\{\\n\.reg \.pred p;\\nsetp\.ne\.b32 p, %69, 0;\\n"'
                r'\s*"wgmma\.mma_async\..*?\);', re.S),
     "host_wgmma_tf32(d, a, desc, scale_d);"),
]
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>()]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(")


def _host_source(text: str) -> str:
    """A CUDA source rewritten for ``HEADER``: dynamic shared memory, the
    launch syntax (the kernel in parentheses: it may be a template-id) and
    the cp.async asm."""
    text = text.replace("extern __shared__ float4 smem4[];",
                        "float4* smem4 = host_dynamic_shared();")
    text = _LAUNCH.sub(r"HOST_LAUNCH(\2, \3, \4, (\1), ", text)
    text = _CP_ASYNC.sub("if (pred) std::memcpy(smem, gmem, 16); "
                         "else std::memset(smem, 0, 16);", text)
    text = _CP_ZFILL.sub("std::memset(smem, 0, 16); std::memcpy(smem, gmem, bytes);",
                         text)
    text = text.replace(_CVT_TF32, "r = host_tf32_rna(x);")
    text = text.replace('asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));', "")
    text = text.replace('asm volatile("cp.async.commit_group;\\n" ::);', "")
    for pattern, host in _WG_ASM:
        text = pattern.sub(host, text)
    if "asm" in text:
        raise RuntimeError("an asm statement the emulation does not know")
    return text


def build_emulated(csrc: str = build.CSRC_DIR) -> str:
    """Compile the sources in ``csrc`` for the host; return the library path
    (kept under ``_build/emulated/``, keyed by the sources)."""
    names = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256(HEADER.encode())
    for f in names:
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    out = os.path.join(build.BUILD_DIR, "emulated", h.hexdigest()[:16])
    lib = os.path.join(out, "libemulated.so")
    if os.path.isfile(lib):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the emulation needs g++")
    tmp = f"{out}.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "cuda_runtime.h"), "w") as fh:
        fh.write(HEADER)
    for f in names:
        with open(os.path.join(csrc, f)) as src, open(os.path.join(tmp, f), "w") as dst:
            dst.write(_host_source(src.read()))
    procs = [(subprocess.Popen(
        [gxx, "-std=c++20", "-O2", "-fPIC", "-w", "-I", tmp, "-include",
         "cuda_runtime.h", "-x", "c++", "-c", os.path.join(tmp, f), "-o",
         os.path.join(tmp, f + ".o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), f) for f in names if f.endswith(".cu")]
    errors = [(f, p.communicate()[0]) for p, f in procs]
    bad = [(f, log) for (f, log), (p, _) in zip(errors, procs) if p.returncode]
    if bad:
        raise RuntimeError("g++ failed:\n" + "\n".join(log for _, log in bad))
    subprocess.run([gxx, "-shared", "-o", os.path.join(tmp, "libemulated.so"),
                    *[os.path.join(tmp, f + ".o") for _, f in procs], "-lpthread"],
                   check=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    try:
        os.rename(tmp, out)
    except OSError:                          # another process built it first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _check_host_input(t, name: str, width: int) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name}: expected float32 (n, {width}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@contextlib.contextmanager
def emulated(csrc: str = build.CSRC_DIR):
    """Within the block, the kernel wrappers launch the host-emulated
    kernels of ``csrc`` on CPU tensors (persistent grids of 3 blocks, so a
    block walks several tiles)."""
    lib = build_emulated(csrc)
    saved = (build.build, build.check_input, build.stream, build.n_blocks)
    build.build = lambda: lib
    build.check_input = _check_host_input
    build.stream = lambda t: 0
    build.n_blocks = lambda device: 3
    build.load_library.cache_clear()
    try:
        yield lib
    finally:
        build.build, build.check_input, build.stream, build.n_blocks = saved
        build.load_library.cache_clear()


# ---------------------------------------------------------------------------
# Every kernel against its plain version
# ---------------------------------------------------------------------------

def nets(width: str, negative_ray: bool = False):
    """(SDF net, color net), the geometric init perturbed: the small widths
    of the CPU tests (SDF scale 1.3) or the default config's."""
    from ...models import fields as F
    from ...models.mlp import perturb_

    if width == "full":
        scfg = F.SDFConfig()
        ccfg = F.ColorConfig(use_negative_ray_vector=negative_ray)
    else:
        scfg = F.SDFConfig(d_out=33, d_hidden=64, n_layers=4, skip_in=(2,),
                           multires=3, scale=1.3)
        ccfg = F.ColorConfig(d_feature=32, d_hidden=48, n_layers=3,
                             multires_view=2,
                             use_negative_ray_vector=negative_ray)
    g = torch.Generator().manual_seed(2)
    return (perturb_(F.SDFNetwork(scfg, torch.Generator().manual_seed(0)), g),
            perturb_(F.ColorNetwork(ccfg, torch.Generator().manual_seed(1)), g))


def _rel(a, b) -> float:
    nb = b.norm().item()
    nd = (a - b.to(a.dtype)).norm().item()
    return nd / nb if nb > 0 else nd


def _vjp(fn, inputs, params, cots):
    for p in params:
        p.grad = None
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    torch.autograd.backward(fn(*ins), cots)
    return ([t.grad if t.grad is not None else torch.zeros_like(t) for t in ins]
            + [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
               for p in params])


def check(width: str = "small", negative_ray: bool = False,
          n: int = 150) -> dict:
    """{check name: (ok, kernel error, limit)} for every kernel of the
    config on n rows; run inside ``emulated()``. Forward checks: largest
    absolute error against the plain version, 1e-4 (grad: 1e-4 of its
    largest entry, at least 1e-4). Backward checks: the worst relative norm
    error of any gradient tensor against f64, where each must be within 2x
    the plain f32 version's or 1e-5."""
    from ...models import fields as F
    from . import color as CK
    from . import outgrad as OG
    from . import pack
    from . import rendercore as RC
    from . import rendercore_cons as RCC
    from . import sdf_out as SO
    from . import sdf_value as SV
    from . import sdf_value_diff as SVD

    torch.manual_seed(0)
    sdf, col = nets(width, negative_ray)
    scfg, ccfg = sdf.cfg, col.cfg
    sdf64, col64 = copy.deepcopy(sdf).double(), copy.deepcopy(col).double()
    x = (torch.rand(n, 4) * 2 - 1) * 1.2
    d = torch.nn.functional.normalize(torch.randn(n, 3), dim=-1)
    res = {}

    def fwd(name, got, ref, scaled=False):
        lim = 1e-4 * (max(1.0, ref.abs().max().item()) if scaled else 1.0)
        err = (got - ref).abs().max().item()
        res[name] = (err <= lim, err, lim)

    def bwd(name, kernel_fn, plain_fn, inputs, modules, cots, weights=True,
            same=None):
        """kernel_fn(*inputs) on ``modules``' weights; plain_fn(modules,
        *inputs) the plain version, in f32 and in f64. Without ``weights``
        the inputs' gradients alone; ``same``, gradients the kernel's must
        equal bit for bit. Returns the kernel's gradients."""
        params = [p for m in modules for p in m.parameters()] if weights else []
        mods64 = [sdf64 if m is sdf else col64 for m in modules]
        got = _vjp(kernel_fn, inputs, params, cots)
        ref = _vjp(lambda *a: plain_fn(modules, *a), inputs, params, cots)
        r64 = _vjp(lambda *a: plain_fn(mods64, *a), [t.double() for t in inputs],
                   [p for m in mods64 for p in m.parameters()] if weights else [],
                   [c.double() for c in cots])
        ok = all(_rel(a, c) <= max(2 * _rel(b, c), 1e-5)
                 for a, b, c in zip(got, ref, r64))
        if same is not None:
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, same))
        res[name] = (ok, max(_rel(a, c) for a, c in zip(got, r64)),
                     max(max(2 * _rel(b, c), 1e-5) for b, c in zip(ref, r64)))
        return got

    def eff(net):
        """Every effective W of ``net``, then every b: a Function's inputs."""
        return build.weight_args(pack.effective_layers(net))

    with torch.no_grad():
        fwd("K2", SV.launch_value(scfg, pack.pack_sdf_value(sdf), x, SV.COUNTER),
            SV.sdf_value_plain(sdf, x))
        if not negative_ray:
            got = RC.launch_fwd(scfg, ccfg, pack.pack_rendercore(sdf, col), x, d)
            for nm, a, b in zip(("sdf", "grad", "color"), got,
                                RC.rendercore_fwd_plain(sdf, col, x, d)):
                fwd(f"K1-fwd {nm}", a, b, scaled=nm == "grad")
        out, grad = OG.launch_outgrad_fwd(scfg, pack.pack_outgrad(sdf), x)
        ref_out, ref_grad = OG.sdf_outgrad_plain(sdf, x)
        fwd("K4-fwd out", out, ref_out)
        fwd("K4-fwd grad", grad, ref_grad, scaled=True)
        g_in = torch.randn(n, 4)
        fwd("K5-fwd", CK.launch_color_fwd(ccfg, pack.pack_color(col), x, d, g_in,
                                          out[:, 1:]),       # a slice of the head
            CK.color_plain(col, x, d, g_in, out[:, 1:]))

    def plain_query(modules, xx, dd):
        o, gr = F.sdf_output_and_gradient_plain(modules[0], xx)
        return o[:, :1], gr, F.color_apply_plain(modules[1], xx, gr, dd, o[:, 1:])

    def kernel_query(xx, dd, frozen=False):
        """The render-core query through K1, or K4 + K5 (negative ray);
        ``frozen``: K1 on weights that need no gradient."""
        if not negative_ray:
            wb = [t.detach() if frozen else t for t in (*eff(sdf), *eff(col))]
            return RC.RenderCore.apply(scfg, ccfg, pack.pack_rendercore(sdf, col), xx,
                                       dd, *wb)
        o, gr = OG.SdfOutGrad.apply(scfg, pack.pack_outgrad(sdf), xx, *eff(sdf))
        return (o[:, :1], gr, CK.ColorMLP.apply(ccfg, pack.pack_color(col), xx, -dd,
                                                -gr, o[:, 1:], *eff(col)))

    def kernel_color(xx, dd, gg, ff):
        head = torch.cat([torch.zeros(n, 1), ff], 1)    # the feature as a slice
        return CK.ColorMLP.apply(ccfg, pack.pack_color(col), xx, dd, gg, head[:, 1:],
                                 *eff(col))

    obar, gbar = torch.randn(n, scfg.d_out), torch.randn(n, 4)
    for chan, (mo, mg) in (("obar", (1, 0)), ("gbar", (0, 1)), ("both", (1, 1))):
        bwd(f"K4-bwd {chan}",
            lambda xx: OG.SdfOutGrad.apply(scfg, pack.pack_outgrad(sdf), xx, *eff(sdf)),
            lambda mods, xx: F.sdf_output_and_gradient_plain(mods[0], xx), [x],
            [sdf], [obar * mo, gbar * mg])
    bwd("K5-bwd", kernel_color, lambda mods, *a: CK.color_plain(mods[0], *a),
        [x, d, g_in, torch.randn(n, ccfg.d_feature) * 0.5], [col],
        [torch.randn(n, 3)])
    rc_cots = [torch.randn(n, 1), torch.randn(n, 4), torch.randn(n, 3)]
    full = bwd("K1-bwd" if not negative_ray else "K4 + K5 composed", kernel_query,
               plain_query, [x, d], [sdf, col], rc_cots)
    if not negative_ray:
        # Frozen fields: x_bar and dirs_bar alone, the full kernel's bit for bit.
        bwd("K1-bwd frozen", lambda xx, dd: kernel_query(xx, dd, frozen=True),
            plain_query, [x, d], [sdf, col], rc_cots, weights=False, same=full[:2])

    # K7 (the SDF output, first order) and, with a positive ray vector, K6
    # (the render core with the consistency query at y folded in).
    y = (torch.rand(n, 4) * 2 - 1) * 1.2
    with torch.no_grad():
        fwd("K7-fwd", SO.launch_out_fwd(scfg, pack.pack_outgrad(sdf), x),
            SO.sdf_out_plain(sdf, x))
        if not negative_ray:
            got = RCC.launch_cons_fwd(scfg, ccfg, pack.pack_rendercore(sdf, col),
                                      x, d, y)
            for nm, a, b in zip(("sdf", "grad", "color", "sdf_w"), got,
                                RCC.rendercore_cons_plain(sdf, col, x, d, y)):
                fwd(f"K6-fwd {nm}", a, b, scaled=nm == "grad")
    bwd("K7-bwd", lambda xx: SO.SdfOut.apply(scfg, pack.pack_outgrad(sdf), xx, *eff(sdf)),
        lambda mods, xx: SO.sdf_out_plain(mods[0], xx), [x], [sdf],
        [torch.randn(n, scfg.d_out)])
    bwd("K3-bwd", lambda xx: SVD.SdfValueDiff.apply(scfg, pack.pack_sdf_value(sdf), xx,
                                                    *eff(sdf)),
        lambda mods, xx: SVD.sdf_value_diff_plain(mods[0], xx), [x], [sdf],
        [torch.randn(n)])
    if not negative_ray:
        bwd("K6-bwd",
            lambda xx, dd, yy: RCC.RenderCoreCons.apply(
                scfg, ccfg, pack.pack_rendercore(sdf, col), xx, dd, yy, *eff(sdf),
                *eff(col)),
            lambda mods, *a: RCC.rendercore_cons_plain(*mods, *a), [x, d, y],
            [sdf, col], [torch.randn(n, 1), torch.randn(n, 4), torch.randn(n, 3),
                         torch.randn(n)])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", choices=("small", "full"), default="small")
    ap.add_argument("--negative-ray", action="store_true")
    ap.add_argument("--csrc", default=build.CSRC_DIR)
    a = ap.parse_args(argv)
    n = 150 if a.width == "small" else 70      # ragged: 2 or 1 full tiles
    with emulated(a.csrc):
        res = check(a.width, a.negative_ray, n)
    for name, (ok, err, lim) in res.items():
        print(f"{'ok  ' if ok else 'FAIL'} {name}: {err:.3g} (limit {lim:.3g})")
    return 0 if all(ok for ok, _, _ in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
