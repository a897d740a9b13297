"""Build, load and launch the port's hand-written CUDA libraries.

Each ``csrc/*.cu`` source is one library with a plain C interface.
``build_library`` compiles the sources for sm_90a into ``BUILD_DIR``, each
library's file name carrying its source's hash, so a source is built once
per content. ``library`` loads one with the ctypes signatures that its
kernel module declares beside its wrapper, and ``launch`` calls an entry
point on a device's current stream, raises when it returns a cudaError and
counts the launch in ``LAYOUT_LAUNCHES``. Nothing is built or loaded
before a kernel's first launch, so a machine without nvcc imports every
module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = {f[:-3]: os.path.join(_CSRC, f) for f in sorted(os.listdir(_CSRC))
           if f.endswith(".cu")}
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# Kernel launches (the CUDA path only) by the key each launch site gives
# ``launch``: (kernel, n_val, n_packed, with_color, residuals or
# values_only) for the compositor (ops/rasterize_cuda.py), (kernel, words)
# for its reduce, ("deform_mlp",) for the fused deform MLP (ops/mlp_cuda.py),
# ("mask_unpack",) for the mask stack's unpack (ops/mask_unpack.py),
# ("smooth_rows_bwd",) for the feature smoothing's backward (ops/knn.py,
# both passes) and ("update_tail", segments) and ("update_commit",) for the
# training steps' update tail (ops/update_tail.py); a launch given a tile
# range (slab mode) adds "slab" to its key. The port's counter "layout_launches" (utils/trace.py).
LAYOUT_LAUNCHES: dict = trace.counter("layout_launches")

# source name -> its loaded library; a tool times a variant build of a
# source by putting it here in the library's place
LIBS: dict = {}


def nvcc() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME (/usr/local/cuda)."""
    path = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if path is None and os.path.exists(home):
        path = home
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "trase_tpu_torch/csrc at first use")
    return path


def _library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_library(names=None) -> dict:
    """Compile csrc sources (every one by default) for sm_90a into
    BUILD_DIR, one nvcc per source, all started together, each written to
    a temporary file and renamed into place. Returns {name: (library path,
    build seconds, nvcc output)}; seconds and output are 0 and "" for a
    library that was already built."""
    names = tuple(SOURCES) if names is None else tuple(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    result, running = {}, {}
    for name in names:
        path = _library_path(name)
        if os.path.exists(path):
            result[name] = (path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        result[name] = (path, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def load(path: str, signatures: dict) -> ctypes.CDLL:
    """The library at `path`, each entry point named in `signatures`
    (name -> argument types, the stream last) typed to return an int, a
    cudaError."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in signatures.items():
        entry = getattr(lib, fn)
        entry.argtypes, entry.restype = list(argtypes), ctypes.c_int
    return lib


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """csrc/<name>.cu's library, built where needed and loaded once."""
    lib = LIBS.get(name)
    if lib is None:
        lib = LIBS[name] = load(build_library([name])[name][0], signatures)
    return lib


def require_cuda(name: str, plain: str, **tensors) -> None:
    """Raise ValueError unless every tensor is a contiguous CUDA tensor:
    kernel `name` takes CUDA tensors, and `plain` is its CPU path."""
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} takes CUDA tensors; the CPU path is "
                             f"{plain}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def launch(entry, key: tuple, device: torch.device, *args) -> None:
    """Call a library's entry point with `args` (a tensor passes its data
    pointer) and `device`'s current stream, with `device` current. Raises
    RuntimeError when it returns a cudaError; counts the launch in
    LAYOUT_LAUNCHES under `key`, whose first item names the kernel."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = entry(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{key[0]} launch failed: cudaError {rc}")
    trace.bump(LAYOUT_LAUNCHES, key)
