"""Lazy build and load of the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. Nothing
happens at import: the first call of ``load_library()`` builds into
``copenerf_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.

Beside the build, the host side every kernel wrapper shares: the library's
entries and their argument types (``ENTRIES``), the call (``call``), the
buffers of a launch (``outputs``, ``bwd_buffers``), the input checks, and
the autograd plumbing (``cotangents``, ``weight_args``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ...utils.profiling import span

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelCounter:
    """Plain-integer launch count of one kernel; its wrapper launches the
    kernel inside ``launch()`` and nowhere else. Every counter made is in
    ``COUNTERS`` (those of the kernel modules imported so far)."""

    def __init__(self, name: str):
        self.name = name
        self.span = "copenerf.kernel." + name
        self.launches = 0
        COUNTERS.append(self)

    def launch(self) -> "_Launch":
        """The host side of one launch (allocations, the library call, its
        check, the unpack of its output buffer, with any wait for the card
        that the unpack makes) inside the span ``copenerf.kernel.<name>``;
        ``launches`` counts it once the block ends without an error."""
        return _Launch(self)


class _Launch:
    __slots__ = ("counter", "region")

    def __init__(self, counter: KernelCounter):
        self.counter = counter
        self.region = span(counter.span)

    def __enter__(self):
        self.region.__enter__()
        return self

    def __exit__(self, *exc):
        self.region.__exit__(*exc)
        if exc[0] is None:
            self.counter.launches += 1
        return False


COUNTERS = []


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR)
                   if f.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, f) for f in names]


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


BUILD_STATS = {"seconds": 0.0, "cached": None, "library": None}


def build() -> str:
    """Compile and link the kernels if needed; return the library path."""
    srcs = _sources()
    lib = os.path.join(BUILD_DIR, f"libcopenerf_kernels_{_digest(srcs)}.so")
    if os.path.isfile(lib):
        BUILD_STATS.update(seconds=0.0, cached=True, library=lib)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{os.getpid()}.o")
        log = open(obj + ".log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT), obj, log))
    # Each source's wall time, read as the processes end, goes to build.log.
    done = {}
    while len(done) < len(procs):
        for proc, obj, log in procs:
            if obj not in done and proc.poll() is not None:
                done[obj] = time.perf_counter() - t0
                log.close()
        time.sleep(0.05)
    failed = [obj for proc, obj, _ in procs if proc.returncode != 0]
    logs = "".join(open(obj + ".log").read() for _, obj, _ in procs)
    logs += "".join(f"nvcc seconds {os.path.basename(obj).split('.cu.')[0]}.cu: "
                    f"{done[obj]:.1f}\n" for _, obj, _ in procs)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = lib + f".{os.getpid()}.tmp"
    subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                    *[o for _, o, _ in procs]], check=True)
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        os.remove(obj)
        os.remove(obj + ".log")
    BUILD_STATS.update(seconds=time.perf_counter() - t0, cached=False,
                       library=lib)
    return lib


def build_log() -> str:
    path = os.path.join(BUILD_DIR, "build.log")
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


# The render-core entries after their row tensors and the parameter
# buffer: the pack's offsets, then the geometry.
_RC_GEOM = [_L] + [_I] * 5 + [_F] + [_I] * 7 + [_P]
_RC_FWD = [_P] * 3 + [_L] * 4 + [_P] * 2 + [_L] + [_P] + _RC_GEOM
_RC_BWD_OFFS = [_P] * 3 + [_L] * 5 + [_P] * 2 + [_L] + [_P] + [_L] * 2
_RC_BWD = _RC_BWD_OFFS + [_P] * 3 + [_L] + [_P] * 5 + _RC_GEOM
_RC_WORKSPACE = [_L] + [_I] * 11 + [_P]

# Every entry of the library (``copenerf_<name>``) and its argument types;
# each returns a CUDA error code, 0 for success.
ENTRIES = {
    "sdf_value": [_P] * 5 + [_L] * 3 + [_I] * 5 + [_F, _P],
    "rendercore_fwd": [_P] * 6 + _RC_FWD,
    "sdf_value_bwd_workspace": [_L] + [_I] * 6 + [_P],
    "sdf_value_bwd": [_P] * 7 + [_L] * 2 + [_P] * 6 + [_L] + [_I] * 5 + [_F, _I, _P],
    "rendercore_bwd_workspace": _RC_WORKSPACE,
    "rendercore_bwd_frozen_workspace": [_I] * 3 + [_P],
    "rendercore_bwd": [_P] * 8 + _RC_BWD,
    "rendercore_bwd_frozen": [_P] * 7 + _RC_BWD_OFFS + [_P] + _RC_GEOM,
    "sdf_outgrad_fwd": [_P] * 7 + [_L] * 4 + [_P, _L] + [_I] * 5 + [_F, _I, _I, _P],
    "sdf_outgrad_bwd_workspace": [_L] + [_I] * 7 + [_P],
    "sdf_outgrad_bwd": ([_P] * 8 + [_L] * 3 + [_P] * 3 + [_L] + [_P] * 3 + [_L]
                        + [_I] * 5 + [_F, _I, _I, _P]),
    "color_fwd": [_P] * 4 + [_L] + [_P] * 4 + [_L] * 2 + [_I] * 6 + [_P],
    "color_bwd_workspace": [_L] + [_I] * 5 + [_P],
    "color_bwd": ([_P] * 4 + [_L] + [_P] * 9 + [_L] * 3 + [_P] * 5 + [_L]
                  + [_I] * 6 + [_P]),
    "rendercore_cons_fwd": [_P] * 8 + _RC_FWD,
    "rendercore_cons_bwd_workspace": _RC_WORKSPACE,
    "rendercore_cons_bwd": [_P] * 11 + _RC_BWD,
    "sdf_out_fwd": [_P] * 5 + [_L] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "sdf_out_bwd_workspace": [_L] + [_I] * 7 + [_P],
    "sdf_out_bwd": [_P] * 7 + [_L] * 3 + [_P] * 6 + [_L] + [_I] * 5 + [_F, _I, _I, _P],
    "tile_gemm_check": [_P] * 3 + [_L] + [_I] * 4 + [_P] * 2,
    "wgrad_check": [_P, _P, _L, _P, _P, _L, _I, _P, _P, _P, _L] + [_I] * 5 + [_P],
}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, "copenerf_" + name)
        fn.argtypes, fn.restype = argtypes, _I
    return lib


def call(entry: str, *args) -> None:
    """Call the library's ``copenerf_<entry>`` on ``args``; raise if it
    reports a CUDA error."""
    check(getattr(load_library(), "copenerf_" + entry)(*args), entry)


def bwd_buffers(entry: str, args, gsize, device):
    """(stage, partial sums, scratch, weight gradients) of one backward
    launch, f32 on ``device``: the first three uninitialized, sized by the
    library's ``copenerf_<entry>_workspace`` on ``args``; the gradients
    ``gsize`` zeros, which the kernel adds into. With ``gsize`` None (a
    backward without weight gradients) the scratch alone."""
    sizes = (_L * 3)()
    call(entry + "_workspace", *args, sizes)
    f32 = dict(dtype=torch.float32, device=device)
    if gsize is None:
        return torch.empty(sizes[2], **f32)
    return (*(torch.empty(s, **f32) for s in sizes), torch.zeros(gsize, **f32))


def outputs(x, *widths) -> list:
    """Uninitialized f32 outputs for the rows of ``x`` on its device:
    (n, w) for each width w, (n,) for None."""
    n = x.shape[0]
    return [torch.empty((n,) if w is None else (n, w), dtype=torch.float32,
                        device=x.device) for w in widths]


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry points
    take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def n_blocks(device) -> int:
    """Blocks of a persistent grid: one per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def offsets(offs: list):
    """A per-layer list of float offsets as a C ``long long`` array."""
    return (_L * len(offs))(*offs)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def check_device(index: int, current: int, name: str) -> None:
    """A kernel input must lie on the current CUDA device: the C entry
    points launch there (and set their attributes there), while ``stream``
    takes the tensor's own device."""
    if index != current:
        raise ValueError(
            f"{name}: tensor on cuda:{index}, but the current device is "
            f"cuda:{current}; call torch.cuda.set_device first")


def check_input(t, name: str, width: int) -> None:
    """A kernel input must be a contiguous f32 (n, width) CUDA tensor on
    the current device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    check_device(t.device.index, torch.cuda.current_device(), name)
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name}: expected shape (n, {width}), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def needs_grad(tensors) -> bool:
    """Whether autograd would need a backward of a call on ``tensors``
    (inputs and weights): grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(tensors, what: str) -> None:
    """The raw forward launchers refuse work that autograd would need: a
    differentiable call goes through the autograd.Functions
    (``sdf_value_diff``, ``rendercore``, ``rendercore_cons``, ``outgrad``,
    ``sdf_out``, ``color``), whose backward is a kernel too."""
    if needs_grad(tensors):
        raise RuntimeError(
            f"{what}: a CUDA input or weight requires grad while grad "
            "mode is on; this launcher is forward-only (run under "
            "torch.no_grad(), or call the differentiable entry point)")


def check_rows(x, *tensors) -> None:
    """Each (tensor, name, width) as ``check_input`` wants it, with the rows
    of x."""
    for t, name, w in tensors:
        check_input(t, name, w)
        if t.shape[0] != x.shape[0]:
            raise ValueError(f"{name}: {t.shape[0]} rows, x has {x.shape[0]}")


def check_pack(params, x) -> None:
    """A pack's weights must lie on the device of the rows they meet."""
    if params.device != x.device:
        raise ValueError(f"weights on {params.device}, x on {x.device}")


def cotangents(x, cots, widths) -> list:
    """Each cotangent contiguous for a backward launch; one that arrives as
    None (an output autograd did not reach) as zeros of x's rows, (n, w)
    for width w, (n,) for None."""
    n = x.shape[0]
    return [torch.zeros((n,) if w is None else (n, w), dtype=x.dtype, device=x.device)
            if c is None else c.contiguous() for c, w in zip(cots, widths)]


def weight_args(*nets_layers) -> tuple:
    """[(W, b)] per layer of each net -> every W, then every b, of the first
    net, then of the next: an autograd.Function's weight inputs, and their
    gradients' place in what its backward returns."""
    out = []
    for layers in nets_layers:
        out += [w for w, _ in layers] + [b for _, b in layers]
    return tuple(out)
