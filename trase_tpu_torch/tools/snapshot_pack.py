"""A run's milestone snapshots in one compact file, for scoring elsewhere.

    python -m trase_tpu_torch.tools.snapshot_pack pack MODEL_DIR PACK
    python -m trase_tpu_torch.tools.snapshot_pack unpack PACK MODEL_DIR

``pack`` keeps, of every snapshot under MODEL_DIR
(point_cloud/iteration_N/point_cloud.ply and deform/iteration_N/
deform.pkl), what the segmentation score reads: the ply's positions,
opacities, scales, rotations and features, and the deform weights. Each
snapshot is stored as its bitwise difference (xor) from the one before
when the two hold the same number of gaussians (what did not change
between milestones costs next to nothing: the features before the
FEATURE phase), split into byte planes and compressed with lzma. Nothing
kept loses a bit.

``unpack`` writes the snapshots back in the layout the port's loaders
read, with the colour columns (f_dc, f_rest) zero: the masks that
``python -m trase_tpu_torch.tools.validate_scale --score_only`` renders
read alpha alone, which colour does not change. A snapshot so unpacked
scores masks; it does not render images.
"""
from __future__ import annotations

import argparse
import json
import lzma
import os

import numpy as np

from ..data.ply import read_ply, write_ply

GEOMETRY = ("x", "y", "z", "opacity", "scale_0", "scale_1", "scale_2",
            "rot_0", "rot_1", "rot_2", "rot_3")


def _paths(model_dir: str, iteration: int) -> tuple:
    return (os.path.join(model_dir, "point_cloud", f"iteration_{iteration}",
                         "point_cloud.ply"),
            os.path.join(model_dir, "deform", f"iteration_{iteration}",
                         "deform.pkl"))


def _compress(words: np.ndarray) -> np.ndarray:
    """(n, c) uint32 -> lzma of its byte planes, column by column."""
    n, c = words.shape
    planes = np.ascontiguousarray(words.T).view(np.uint8).reshape(c, n, 4)
    return np.frombuffer(lzma.compress(
        np.ascontiguousarray(planes.transpose(2, 0, 1)).tobytes()), np.uint8)


def _decompress(blob: np.ndarray, n: int, c: int) -> np.ndarray:
    planes = np.frombuffer(lzma.decompress(blob.tobytes()), np.uint8)
    cols = np.ascontiguousarray(planes.reshape(4, c, n).transpose(1, 2, 0))
    return np.ascontiguousarray(cols.view("<u4").reshape(c, n).T)


def pack(model_dir: str, pack_path: str) -> dict:
    """Every snapshot with a ply and a deform.pkl under model_dir into
    pack_path (an .npz of compressed byte arrays); returns its metadata."""
    pc = os.path.join(model_dir, "point_cloud")
    iterations = sorted(
        int(d.split("_")[-1]) for d in os.listdir(pc)
        if d.startswith("iteration_")
        and all(os.path.exists(p) for p in _paths(model_dir,
                                                  int(d.split("_")[-1]))))
    meta = {"iterations": iterations, "n": [], "columns": None,
            "f_rest": None, "xor": []}
    blobs = {}
    prev_words, prev_deform = None, None
    for it in iterations:
        ply_path, deform_path = _paths(model_dir, it)
        props = read_ply(ply_path)
        feats = sorted((k for k in props if k.startswith("gaussian_feats_")),
                       key=lambda s: int(s.split("_")[-1]))
        columns = list(GEOMETRY) + feats
        meta["columns"] = meta["columns"] or columns
        if columns != meta["columns"]:
            raise ValueError(f"{ply_path}: columns differ from the first "
                             "snapshot's")
        meta["f_rest"] = sum(k.startswith("f_rest_") for k in props)
        words = np.stack([np.asarray(props[k], "<f4") for k in columns],
                         axis=1).view("<u4")
        with open(deform_path, "rb") as f:
            deform = np.frombuffer(f.read(), np.uint8)
        xor = prev_words is not None and prev_words.shape == words.shape
        blobs[f"ply_{it}"] = _compress(words ^ prev_words if xor else words)
        dxor = prev_deform is not None and prev_deform.size == deform.size
        blobs[f"deform_{it}"] = np.frombuffer(lzma.compress(
            (deform ^ prev_deform if dxor else deform).tobytes()), np.uint8)
        meta["n"].append(len(words))
        meta["xor"].append([bool(xor), bool(dxor)])
        prev_words, prev_deform = words, deform
    blobs["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(pack_path)), exist_ok=True)
    with open(pack_path, "wb") as f:
        np.savez(f, **blobs)
    return meta


def unpack(pack_path: str, model_dir: str) -> dict:
    """Write pack_path's snapshots under model_dir (colour zero); returns
    its metadata."""
    z = np.load(pack_path)
    meta = json.loads(z["meta"].tobytes())
    columns = meta["columns"]
    prev_words, prev_deform = None, None
    for it, n, (xor, dxor) in zip(meta["iterations"], meta["n"],
                                  meta["xor"]):
        words = _decompress(z[f"ply_{it}"], n, len(columns))
        if xor:
            words = words ^ prev_words
        deform = np.frombuffer(lzma.decompress(z[f"deform_{it}"].tobytes()),
                               np.uint8)
        if dxor:
            deform = deform ^ prev_deform
        prev_words, prev_deform = words, deform
        values = words.view("<f4")
        zero = np.zeros(n, np.float32)
        props = {"x": values[:, 0], "y": values[:, 1], "z": values[:, 2],
                 "nx": zero, "ny": zero, "nz": zero}
        props.update({f"f_dc_{i}": zero for i in range(3)})
        props.update({f"f_rest_{i}": zero for i in range(meta["f_rest"])})
        props.update({k: values[:, j] for j, k in enumerate(columns)
                      if k not in ("x", "y", "z")})
        ply_path, deform_path = _paths(model_dir, it)
        os.makedirs(os.path.dirname(ply_path), exist_ok=True)
        write_ply(ply_path, props)
        os.makedirs(os.path.dirname(deform_path), exist_ok=True)
        with open(deform_path, "wb") as f:
            f.write(deform.tobytes())
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack", help="MODEL_DIR -> PACK")
    p.add_argument("model_dir")
    p.add_argument("pack")
    u = sub.add_parser("unpack", help="PACK -> MODEL_DIR")
    u.add_argument("pack")
    u.add_argument("model_dir")
    args = ap.parse_args(argv)
    if args.cmd == "pack":
        meta = pack(args.model_dir, args.pack)
        print(f"packed iterations {meta['iterations']} "
              f"({os.path.getsize(args.pack)} bytes) -> {args.pack}")
    else:
        meta = unpack(args.pack, args.model_dir)
        print(f"unpacked iterations {meta['iterations']} -> "
              f"{args.model_dir}")
    return meta


if __name__ == "__main__":
    main()
