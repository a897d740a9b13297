"""SAM mask loading/decoding (numpy; torch only for reference .pt files).

Counterpart of trase_tpu/data/masks.py. The reference stores per-image SAM masks as
``masks/<name>.pt`` holding either a raw (N,H,W) bool tensor or a dict
{"masks": np.array of bitarray, "N", "H", "W"} (extract_masks.py:87-99).
``decode_mask_file`` accepts .pt, the native .npz format (packed bits +
shape, written by ``save_mask_file``) and .npy. The FEATURE step takes
one static (M_max, H, W) float32 stack per dataset with a validity
vector (``pad_masks``, ``load_padded_masks``: the native .npz format
through the C++ unpacker of ``native.py``). ``MaskPrefetcher`` decodes
on a background thread, so the training loop can start the next
camera's decode before the current step; each decode is the span
``trase.masks.decode`` of the iteration that submitted it.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import NamedTuple

import numpy as np

from ..utils import trace


class PaddedMasks(NamedTuple):
    masks: np.ndarray  # (M_max, H, W) float32
    valid: np.ndarray  # (M_max,) bool


def decode_mask_file(path: str) -> np.ndarray | None:
    """Load one mask file -> (N, H, W) bool array."""
    if not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        z = np.load(path)
        if "packed" in z:
            n, h, w = int(z["N"]), int(z["H"]), int(z["W"])
            bits = np.unpackbits(z["packed"], count=n * h * w)
            return bits.reshape(n, h, w).astype(bool)
        return z["masks"].astype(bool)
    if path.endswith(".npy"):
        return np.load(path).astype(bool)
    # torch .pt — raw tensor or bitarray dict
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if torch.is_tensor(obj):
        return obj.numpy().astype(bool)
    if isinstance(obj, dict):
        n, h, w = int(obj["N"]), int(obj["H"]), int(obj["W"])
        m = obj["masks"]
        if torch.is_tensor(m):
            return m.numpy().reshape(n, h, w).astype(bool)
        # bitarray container (reference format: ONE bitarray of all
        # N*H*W bits, extract_masks.py:92-99) or an array of per-mask
        # bitarrays, or raw bytes
        objs = list(np.asarray(m, dtype=object).ravel()) \
            if isinstance(m, np.ndarray) else [m]
        per_obj = (n * h * w) if len(objs) == 1 else (h * w)
        flat = []
        for ba in objs:
            if hasattr(ba, "tobytes"):
                packed = np.frombuffer(ba.tobytes(), dtype=np.uint8)
                bits = np.unpackbits(packed, count=per_obj)
            else:
                bits = np.asarray(ba, dtype=np.uint8).ravel()[:per_obj]
            flat.append(bits)
        return np.concatenate(flat).reshape(n, h, w).astype(bool)
    raise ValueError(f"Unrecognized mask container in {path}")


def mask_file_shape(path: str) -> tuple | None:
    """(N, H, W) of a mask file without decoding the bits, when the
    container carries shape metadata (.npz native format, .pt dicts).
    Returns None when a full decode is required."""
    if not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        z = np.load(path)
        if "packed" in z:
            return (int(z["N"]), int(z["H"]), int(z["W"]))
        return tuple(z["masks"].shape)
    if path.endswith(".pt"):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict):
            return (int(obj["N"]), int(obj["H"]), int(obj["W"]))
        if torch.is_tensor(obj):
            return tuple(obj.shape)
    return None


def save_mask_file(path: str, masks: np.ndarray):
    """Native .npz format: bit-packed, shape-tagged."""
    n, h, w = masks.shape
    packed = np.packbits(masks.astype(bool).ravel())
    np.savez_compressed(path, packed=packed, N=n, H=h, W=w)


def pad_masks(masks: np.ndarray, m_max: int) -> PaddedMasks:
    """(N, H, W) masks -> the first m_max of them as float32, padded with
    all-zero masks to (m_max, H, W), and which slots are real."""
    n = masks.shape[0]
    if n >= m_max:
        return PaddedMasks(masks=masks[:m_max].astype(np.float32),
                           valid=np.ones(m_max, bool))
    pad = np.zeros((m_max - n,) + masks.shape[1:], np.float32)
    return PaddedMasks(masks=np.concatenate([masks.astype(np.float32), pad]),
                       valid=np.arange(m_max) < n)


def load_padded_masks(path: str, m_max: int) -> PaddedMasks | None:
    """Decode + pad (None when the file is missing). The native bit-packed
    .npz format goes through native.unpack_masks_padded: one pass instead
    of unpackbits / reshape / astype / pad."""
    if path.endswith(".npz") and os.path.exists(path):
        z = np.load(path)
        if "packed" in z:
            from ..native import unpack_masks_padded

            n, h, w = int(z["N"]), int(z["H"]), int(z["W"])
            padded = unpack_masks_padded(np.asarray(z["packed"]), n, h, w,
                                         m_max)
            return PaddedMasks(masks=padded, valid=np.arange(m_max) < n)
    masks = decode_mask_file(path)
    return None if masks is None else pad_masks(masks, m_max)


class MaskPrefetcher:
    """Decodes mask files on one background thread (trase_tpu's
    MaskPrefetcher; the reference decodes on the critical path,
    train.py:246-249). ``submit`` queues a path, ``get`` returns the next
    decoded (path, PaddedMasks or None) in submission order and re-raises
    a decode's exception; at most `depth` results wait decoded. ``close``
    stops the thread: it drops what was not taken."""

    def __init__(self, m_max: int, depth: int = 4):
        self.m_max = m_max
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._jobs: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mask-prefetch")
        self._thread.start()

    def _worker(self):
        while True:
            job = self._jobs.get()
            if job is None or self._stop.is_set():
                return
            path, iteration = job
            try:
                with trace.span("trase.masks.decode", iteration=iteration):
                    result = load_padded_masks(path, self.m_max)
            except Exception as e:  # noqa: BLE001 — handed to get()
                result = e
            self._q.put((path, result))

    def submit(self, path: str):
        self._jobs.put((path, trace.current_iteration()))

    def get(self) -> tuple[str, PaddedMasks | None]:
        path, result = self._q.get()
        if isinstance(result, Exception):
            raise result
        return path, result

    def close(self):
        self._stop.set()
        self._jobs.put(None)
        while self._thread.is_alive():  # free a put blocked on a full queue
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()
