"""Lazy build and load of the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. Nothing
happens at import: the first call of ``load_library()`` builds into
``copenerf_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
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


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.copenerf_sdf_value.argtypes = [_P] * 5 + [_L] * 3 + [_I] * 5 + [_F, _P]
    # The render-core entries after their row tensors and the parameter
    # buffer: the pack's offsets, then the geometry.
    rc_geom = [_L] + [_I] * 5 + [_F] + [_I] * 7 + [_P]
    rc_fwd = [_P] * 3 + [_L] * 4 + [_P] * 2 + [_L] + [_P] + rc_geom
    lib.copenerf_rendercore_fwd.argtypes = [_P] * 6 + rc_fwd
    lib.copenerf_sdf_value_bwd_workspace.argtypes = [
        _L, _I, _I, _I, _I, _I, _I, _P]
    lib.copenerf_sdf_value_bwd.argtypes = (
        [_P] * 7 + [_L] * 2 + [_P] * 6 + [_L] + [_I] * 5 + [_F, _I, _P])
    lib.copenerf_rendercore_bwd_workspace.argtypes = [
        _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.copenerf_rendercore_bwd_frozen_workspace.argtypes = [_I, _I, _I, _P]
    rc_bwd_offs = [_P] * 3 + [_L] * 5 + [_P] * 2 + [_L] + [_P] + [_L] * 2
    rc_bwd = rc_bwd_offs + [_P] * 3 + [_L] + [_P] * 5 + rc_geom
    lib.copenerf_rendercore_bwd.argtypes = [_P] * 8 + rc_bwd
    lib.copenerf_rendercore_bwd_frozen.argtypes = (
        [_P] * 7 + rc_bwd_offs + [_P] + rc_geom)
    lib.copenerf_sdf_outgrad_fwd.argtypes = (
        [_P] * 7 + [_L] * 4 + [_P, _L] + [_I] * 5 + [_F, _I, _I, _P])
    lib.copenerf_sdf_outgrad_bwd_workspace.argtypes = [_L] + [_I] * 7 + [_P]
    lib.copenerf_sdf_outgrad_bwd.argtypes = (
        [_P] * 8 + [_L] * 3 + [_P] * 3 + [_L] + [_P] * 3 + [_L] + [_I] * 5
        + [_F, _I, _I, _P])
    lib.copenerf_color_fwd.argtypes = (
        [_P] * 4 + [_L] + [_P] * 4 + [_L] * 2 + [_I] * 6 + [_P])
    lib.copenerf_color_bwd_workspace.argtypes = [_L] + [_I] * 5 + [_P]
    lib.copenerf_color_bwd.argtypes = (
        [_P] * 4 + [_L] + [_P] * 9 + [_L] * 3 + [_P] * 5 + [_L] + [_I] * 6 + [_P])
    lib.copenerf_rendercore_cons_fwd.argtypes = [_P] * 8 + rc_fwd
    lib.copenerf_rendercore_cons_bwd_workspace.argtypes = (
        lib.copenerf_rendercore_bwd_workspace.argtypes)
    lib.copenerf_rendercore_cons_bwd.argtypes = [_P] * 11 + rc_bwd
    lib.copenerf_sdf_out_fwd.argtypes = (
        [_P] * 5 + [_L] * 5 + [_I] * 5 + [_F, _I, _I, _P])
    lib.copenerf_sdf_out_bwd_workspace.argtypes = [_L] + [_I] * 7 + [_P]
    lib.copenerf_sdf_out_bwd.argtypes = (
        [_P] * 7 + [_L] * 3 + [_P] * 6 + [_L] + [_I] * 5 + [_F, _I, _I, _P])
    lib.copenerf_tile_gemm_check.argtypes = [_P] * 3 + [_L] + [_I] * 4 + [_P] * 2
    lib.copenerf_wgrad_check.argtypes = (
        [_P, _P, _L, _P, _P, _L, _I, _P, _P, _P, _L] + [_I] * 5 + [_P])
    for fn in (lib.copenerf_sdf_value, lib.copenerf_rendercore_fwd,
               lib.copenerf_sdf_value_bwd_workspace, lib.copenerf_sdf_value_bwd,
               lib.copenerf_rendercore_bwd_workspace,
               lib.copenerf_rendercore_bwd_frozen_workspace,
               lib.copenerf_rendercore_bwd, lib.copenerf_rendercore_bwd_frozen,
               lib.copenerf_sdf_outgrad_fwd,
               lib.copenerf_sdf_outgrad_bwd_workspace,
               lib.copenerf_sdf_outgrad_bwd, lib.copenerf_color_fwd,
               lib.copenerf_color_bwd_workspace, lib.copenerf_color_bwd,
               lib.copenerf_rendercore_cons_fwd,
               lib.copenerf_rendercore_cons_bwd_workspace,
               lib.copenerf_rendercore_cons_bwd, lib.copenerf_sdf_out_fwd,
               lib.copenerf_sdf_out_bwd_workspace, lib.copenerf_sdf_out_bwd,
               lib.copenerf_tile_gemm_check, lib.copenerf_wgrad_check):
        fn.restype = _I
    return lib


def workspace(fn, *args) -> list:
    """The three float counts a backward's ``*_workspace`` entry reports:
    staged rows, partial sums, per-block scratch."""
    out = (_L * 3)()
    check(fn(*args, out), fn.__name__)
    return list(out)


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
