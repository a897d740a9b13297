"""Minimal PLY reader/writer (numpy structured arrays; no plyfile dep).

Supports binary_little_endian and ascii 'vertex'-element files — the
formats produced/consumed by the reference (point clouds and trained
gaussian snapshots, scene/gaussian_model.py:317-455 and
scene/dataset_readers.py:165-188).
"""
from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_NP_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of 1-D arrays per property."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        elements = []  # list of (name, count, [(prop_name, np_type)])
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise ValueError("list properties not supported")
                elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))

        out = {}
        for name, count, props in elements:
            dtype = np.dtype(
                [(p, ("<" if fmt.endswith("little_endian") else ">") + t)
                 for p, t in props]
            )
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(
                        tuple(
                            float(v)
                            for v in f.readline().decode("ascii").split()
                        )
                    )
                data = np.array(rows, dtype=dtype)
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize),
                                     dtype=dtype, count=count)
            if name == "vertex":
                out = {p: np.ascontiguousarray(data[p]) for p, _ in props}
        return out


def write_ply(path: str, properties: dict[str, np.ndarray]):
    """Write a binary_little_endian PLY with one 'vertex' element."""
    names = list(properties.keys())
    n = len(next(iter(properties.values())))
    dtype = np.dtype(
        [(k, "<" + _NP_TO_PLY_key(properties[k])) for k in names]
    )
    data = np.empty(n, dtype=dtype)
    for k in names:
        data[k] = np.asarray(properties[k]).reshape(n)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for k in names:
            base = dtype[k].str[-2:]
            f.write(f"property {_NP_TO_PLY[base]} {k}\n".encode())
        f.write(b"end_header\n")
        f.write(data.tobytes())


def _NP_TO_PLY_key(arr: np.ndarray) -> str:
    base = np.asarray(arr).dtype.str.lstrip("<>|=")
    if base not in _NP_TO_PLY:
        base = "f4"
    return base


def read_point_cloud(path: str):
    """Read an x/y/z[/red/green/blue][/nx/ny/nz] point cloud
    (dataset_readers.fetchPly contract)."""
    from ..utils.graphics import BasicPointCloud

    props = read_ply(path)
    points = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(
        np.float32
    )
    if "red" in props:
        colors = (
            np.stack([props["red"], props["green"], props["blue"]], axis=1)
            / 255.0
        ).astype(np.float32)
    else:
        colors = np.full_like(points, 0.5)
    if "nx" in props:
        normals = np.stack([props["nx"], props["ny"], props["nz"]], axis=1)
    else:
        normals = np.zeros_like(points)
    return BasicPointCloud(points=points, colors=colors,
                           normals=normals.astype(np.float32))


def write_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """storePly contract: xyz float32 + normals + u1 rgb."""
    normals = np.zeros_like(xyz, dtype=np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
            "red": rgb[:, 0].astype(np.uint8),
            "green": rgb[:, 1].astype(np.uint8),
            "blue": rgb[:, 2].astype(np.uint8),
        },
    )
