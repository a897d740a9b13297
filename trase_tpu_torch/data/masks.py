"""SAM mask loading/decoding (numpy; torch only for reference .pt files).

Counterpart of the reader-facing half of trase_tpu/data/masks.py. The
reference stores per-image SAM masks as ``masks/<name>.pt`` holding
either a raw (N,H,W) bool tensor or a dict
{"masks": np.array of bitarray, "N", "H", "W"} (extract_masks.py:87-99).
``decode_mask_file`` accepts .pt, the native .npz format (packed bits +
shape) and .npy. The padded/prefetched training-side loaders belong to
the training slice.
"""
from __future__ import annotations

import os

import numpy as np


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
