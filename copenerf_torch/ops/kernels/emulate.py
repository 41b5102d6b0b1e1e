"""Host emulation of the port's CUDA kernels, for checking them without a card.

    python -m copenerf_torch.ops.kernels.emulate [--width small|full]
        [--negative-ray] [--csrc DIR]

Each ``csrc/*.cu`` is compiled by ``g++`` as C++ against ``HEADER``, which
implements the CUDA subset the kernels use on host threads: one
``std::thread`` per CUDA thread, the blocks of a launch in turn,
``std::barrier`` for ``__syncthreads`` and the warp shuffles, shared memory
filled with NaN at each block's start (a read before a write shows), and
``cp.async`` as a synchronous copy. A copy of the sources under
``_build/emulated/`` has the launch syntax and the ``asm`` of
``mlp_tile.cuh`` rewritten. ``emulated()`` points the wrappers' ``build``
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
#include <cmath>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
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
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline float __expf(float x) { return std::exp(x); }
inline float __logf(float x) { return std::log(x); }
inline float __frcp_rn(float x) { return 1.0f / x; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline std::barrier<>* host_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> host_warp_barriers;
inline std::vector<std::array<float, 32>> host_shuffle;
inline float4* host_shared;
inline float4* host_dynamic_shared() { return host_shared; }
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
  std::vector<float4> shared(smem / 16 + 1);
  host_shared = shared.data();
  std::barrier<> bar(nt);
  host_block_barrier = &bar;
  host_warp_barriers.clear();
  for (int w = 0; w < (nt + 31) / 32; ++w)
    host_warp_barriers.emplace_back(new std::barrier<>(32));
  host_shuffle.assign((nt + 31) / 32, {});
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      for (auto& f : shared) f = float4{nan, nan, nan, nan};
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t, bx, by] {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {bx, by, 0};
          fn();
        });
      for (auto& th : threads) th.join();
    }
}
#define HOST_LAUNCH(G, B, S, K, ...) host_launch(dim3(G), dim3(B), S, [&] { K(__VA_ARGS__); })
"""

_CP_ASYNC = re.compile(
    r"const unsigned dst = \(unsigned\)__cvta_generic_to_shared\(smem\);\s*"
    r"const int src_bytes = pred \? 16 : 0;\s*asm volatile\(.*?\"r\"\(src_bytes\)\);",
    re.S)
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
    text = text.replace('asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));', "")
    text = text.replace('asm volatile("cp.async.commit_group;\\n" ::);', "")
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

    def bwd(name, kernel_fn, plain_fn, inputs, modules, cots):
        """kernel_fn(*inputs) on ``modules``' weights; plain_fn(modules,
        *inputs) the plain version, in f32 and in f64."""
        params = [p for m in modules for p in m.parameters()]
        mods64 = [sdf64 if m is sdf else col64 for m in modules]
        got = _vjp(kernel_fn, inputs, params, cots)
        ref = _vjp(lambda *a: plain_fn(modules, *a), inputs, params, cots)
        r64 = _vjp(lambda *a: plain_fn(mods64, *a), [t.double() for t in inputs],
                   [p for m in mods64 for p in m.parameters()],
                   [c.double() for c in cots])
        ok = all(_rel(a, c) <= max(2 * _rel(b, c), 1e-5)
                 for a, b, c in zip(got, ref, r64))
        res[name] = (ok, max(_rel(a, c) for a, c in zip(got, r64)),
                     max(max(2 * _rel(b, c), 1e-5) for b, c in zip(ref, r64)))

    def eff(net):
        """Every effective W of ``net``, then every b: a Function's inputs."""
        ws, bs = zip(*pack.effective_layers(net))
        return (*ws, *bs)

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

    def kernel_query(xx, dd):
        """The render-core query through K1, or K4 + K5 (negative ray)."""
        if not negative_ray:
            return RC.RenderCore.apply(scfg, ccfg, xx, dd, *eff(sdf), *eff(col))
        o, gr = OG.SdfOutGrad.apply(scfg, xx, *eff(sdf))
        return (o[:, :1], gr,
                CK.ColorMLP.apply(ccfg, xx, -dd, -gr, o[:, 1:], *eff(col)))

    def kernel_color(xx, dd, gg, ff):
        head = torch.cat([torch.zeros(n, 1), ff], 1)    # the feature as a slice
        return CK.ColorMLP.apply(ccfg, xx, dd, gg, head[:, 1:], *eff(col))

    obar, gbar = torch.randn(n, scfg.d_out), torch.randn(n, 4)
    for chan, (mo, mg) in (("obar", (1, 0)), ("gbar", (0, 1)), ("both", (1, 1))):
        bwd(f"K4-bwd {chan}", lambda xx: OG.SdfOutGrad.apply(scfg, xx, *eff(sdf)),
            lambda mods, xx: F.sdf_output_and_gradient_plain(mods[0], xx), [x],
            [sdf], [obar * mo, gbar * mg])
    bwd("K5-bwd", kernel_color, lambda mods, *a: CK.color_plain(mods[0], *a),
        [x, d, g_in, torch.randn(n, ccfg.d_feature) * 0.5], [col],
        [torch.randn(n, 3)])
    bwd("K1-bwd" if not negative_ray else "K4 + K5 composed", kernel_query,
        plain_query, [x, d], [sdf, col],
        [torch.randn(n, 1), torch.randn(n, 4), torch.randn(n, 3)])

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
    bwd("K7-bwd", lambda xx: SO.SdfOut.apply(scfg, xx, *eff(sdf)),
        lambda mods, xx: SO.sdf_out_plain(mods[0], xx), [x], [sdf],
        [torch.randn(n, scfg.d_out)])
    bwd("K3-bwd", lambda xx: SVD.SdfValueDiff.apply(scfg, xx, *eff(sdf)),
        lambda mods, xx: SVD.sdf_value_diff_plain(mods[0], xx), [x], [sdf],
        [torch.randn(n)])
    if not negative_ray:
        bwd("K6-bwd",
            lambda xx, dd, yy: RCC.RenderCoreCons.apply(scfg, ccfg, xx, dd, yy,
                                                        *eff(sdf), *eff(col)),
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
