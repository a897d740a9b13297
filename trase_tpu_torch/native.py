"""ctypes binding to the native host-IO library (native/trase_io.cpp).

Counterpart of trase_tpu/native.py, over the same C++ source: bit-
unpacking SAM mask stacks into a zero-padded float32 stack and RGBA ->
float32 RGB conversion, full-array passes that numpy does in 3-4 sweeps
on one thread. The library is compiled with g++ at first use into
trase_tpu_torch/build/ (its name carries the source's hash; written under
a temporary name and renamed into place, so processes that build it at
the same moment never load a half-written file). Each entry point keeps
trase_tpu's numpy path, taken where no library could be built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "trase_io.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libtrase_io_{digest}.so")


def _build() -> str:
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE,
                            "-lpthread"], check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            print(f"[native] trase_io unavailable ({e} "
                  f"{detail.decode(errors='replace').strip()}); numpy path")
            return None
        lib.unpack_masks_padded.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.unpack_masks_padded.restype = None
        lib.rgba_to_rgb_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.rgba_to_rgb_f32.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unpack_masks_padded(packed: np.ndarray, n: int, h: int, w: int,
                        m_max: int) -> np.ndarray:
    """Bit-packed (np.packbits, MSB-first) -> (m_max, h, w) float32, rows
    >= n zeroed."""
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.size * 8 < n * h * w:
        raise ValueError(f"{packed.size} packed bytes hold fewer than the "
                         f"{n}x{h}x{w} bits asked for")
    lib = _load()
    if lib is None:
        bits = np.unpackbits(packed, count=n * h * w)
        out = np.zeros((m_max, h, w), np.float32)
        k = min(n, m_max)
        out[:k] = bits.reshape(n, h, w)[:k]
        return out
    out = np.empty((m_max, h, w), np.float32)
    lib.unpack_masks_padded(packed.ctypes.data, n, h, w, m_max,
                            out.ctypes.data)
    return out


def rgba_to_rgb_f32(img: np.ndarray, bg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """(H, W, 4|3) uint8 -> (3, H, W) float32 composited on bg."""
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {img.shape}")
    has_alpha = img.shape[-1] == 4
    lib = _load()
    if lib is None:
        data = img.astype(np.float32) / 255.0
        bgn = np.asarray(bg, np.float32)
        if has_alpha:
            arr = data[..., :3] * data[..., 3:4] + bgn * (1 - data[..., 3:4])
        else:
            arr = data
        return np.clip(arr.transpose(2, 0, 1), 0, 1).astype(np.float32)
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    bgn = np.ascontiguousarray(np.asarray(bg, np.float32))
    out = np.empty((3, h, w), np.float32)
    lib.rgba_to_rgb_f32(img.ctypes.data, h, w, int(has_alpha),
                        bgn.ctypes.data, out.ctypes.data)
    return out
