"""Gaussian snapshot I/O: the reference's PLY layout + checkpoints.

Counterpart of trase_tpu/models/gaussians_io.py. PLY layout contract
(scene/gaussian_model.py:317-376, load:388-455): properties x,y,z,
nx,ny,nz (zeros), f_dc_{0..2}, f_rest_{0..3*R-1} (channel-major: all
coeffs of channel 0, then channel 1, ...), opacity, scale_{0..2},
rot_{0..3}, gaussian_feats_{0..31}, optional cls. Values are RAW
(pre-activation) parameters. Checkpoints are plain pickles of numpy
trees, the format trase_tpu writes (e.g. deform/iteration_N/deform.pkl).

Both writers write a temporary file beside the target and rename it over
the target (``os.replace``), so a failed or interrupted write leaves the
earlier file as it was. ``load_checkpoint`` reads trase_tpu's full
training checkpoints (chkpnt<N>.pkl) without importing trase_tpu: its
NamedTuples unpickle as plain stand-ins with the same field names, and
any other trase_tpu, jax or flax class is refused by name.
"""
from __future__ import annotations

import collections
import os
import pickle

import numpy as np
import torch

from ..data.ply import read_ply, write_ply
from ..engine.optim import AdamState
from . import gaussians as G


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _atomic_write(path: str, write):
    """write(temporary path) in path's directory, then rename that file
    over `path`; the temporary file goes if `write` fails."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_gaussian_ply(
    path: str,
    params: G.GaussianParams,
    alive,
    mask=None,
    smoothed_features=None,
    with_cluster_ids: bool = False,
):
    """Write alive (optionally masked) gaussians in the reference layout."""
    keep = _np(alive).astype(bool)
    if mask is not None:
        keep = keep & _np(mask).astype(bool)

    xyz = _np(params.xyz)[keep]
    n = xyz.shape[0]
    f_dc = _np(params.features_dc)[keep]  # (n, 1, 3)
    f_rest = _np(params.features_rest)[keep]  # (n, R, 3)
    opacity = _np(params.opacity)[keep]
    scale = _np(params.scaling)[keep]
    rot = _np(params.rotation)[keep]
    feats = _np(smoothed_features if smoothed_features is not None
                else params.gaussian_features)[keep]

    props: dict[str, np.ndarray] = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    # channel-major: transpose (n, R, 3) -> (n, 3, R) then flatten
    dc_t = f_dc.transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc_t.shape[1]):
        props[f"f_dc_{i}"] = dc_t[:, i]
    rest_t = f_rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest_t.shape[1]):
        props[f"f_rest_{i}"] = rest_t[:, i]
    props["opacity"] = opacity[:, 0]
    for i in range(3):
        props[f"scale_{i}"] = scale[:, i]
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]
    for i in range(feats.shape[1]):
        props[f"gaussian_feats_{i}"] = feats[:, i]
    if with_cluster_ids:
        props["cls"] = _np(params.cluster_id)[keep][:, 0]
    props = {k: np.asarray(v, np.float32) if k != "cls" else v
             for k, v in props.items()}
    _atomic_write(path, lambda tmp: write_ply(tmp, props))


def load_gaussian_ply(path: str, sh_degree: int = 3,
                      capacity: int | None = None,
                      feature_dim: int = G.FEATURE_DIM,
                      device="cuda"):
    """Load a snapshot into a fresh fixed-capacity field on `device`.
    Also accepts gaussian-grouping style `obj_dc_*` feature names and
    missing features (random init), like the reference loader
    (:429-443).

    Returns (params, aux, n, has_cluster_ids).
    """
    props = read_ply(path)
    n = len(props["x"])
    xyz = np.stack([props["x"], props["y"], props["z"]], axis=1)

    f_dc = np.stack([props[f"f_dc_{i}"] for i in range(3)], axis=1)  # (n,3)
    rest_names = sorted(
        (k for k in props if k.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    # infer the actual SH degree from the file (a snapshot trained at a
    # lower degree is still loadable; callers get the real degree back)
    r_file = len(rest_names) // 3
    deg_file = int(round(np.sqrt(r_file + 1))) - 1
    if (deg_file + 1) ** 2 - 1 == r_file and deg_file != sh_degree:
        sh_degree = deg_file
    r = (sh_degree + 1) ** 2 - 1
    if len(rest_names) != 3 * r:
        raise ValueError(f"{path}: {len(rest_names)} f_rest properties, "
                         f"expected {3 * r}")
    rest = np.stack([props[k] for k in rest_names], axis=1) \
        if r else np.zeros((n, 0), np.float32)  # (n, 3r)
    rest = rest.reshape(n, 3, r).transpose(0, 2, 1)  # (n, r, 3)

    scales = np.stack([props[f"scale_{i}"] for i in range(3)], axis=1)
    rots = np.stack([props[f"rot_{i}"] for i in range(4)], axis=1)
    opacity = props["opacity"][:, None]

    feats = np.zeros((n, feature_dim), np.float32)
    got = False
    for prefix in ("gaussian_feats_", "obj_dc_"):
        if f"{prefix}0" in props:
            for i in range(feature_dim):
                key = f"{prefix}{i}"
                if key in props:
                    feats[:, i] = props[key]
            got = True
            break
    if not got:
        feats = np.random.randn(n, feature_dim).astype(np.float32)

    has_cls = "cls" in props

    if capacity is None:
        capacity = G.default_capacity(n)
    params = G.empty_params(capacity, sh_degree, device)
    aux = G.empty_aux(capacity, device)
    dev = params.xyz.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    params.xyz[:n] = t(xyz)
    params.features_dc[:n] = t(f_dc[:, None, :])
    params.features_rest[:n] = t(rest)
    params.scaling[:n] = t(scales)
    params.rotation[:n] = t(rots)
    params.opacity[:n] = t(opacity)
    params.gaussian_features[:n] = t(feats)
    if has_cls:
        params.cluster_id[:n] = t(props["cls"][:, None])
    aux.alive[:n] = True
    return params, aux, n, has_cls


def _to_numpy_tree(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy_tree(v) for v in x)
    return x


def save_checkpoint(path: str, payload: dict):
    """Pickle a tree of tensors / arrays as numpy (trase_tpu's format)."""
    tree = _to_numpy_tree(payload)

    def write(tmp):
        with open(tmp, "wb") as f:
            pickle.dump(tree, f)

    _atomic_write(path, write)


def _standin(name: str, fields) -> type:
    return collections.namedtuple(name, tuple(fields))


# trase_tpu's containers in its checkpoints, by (module, class): each
# unpickles as a namedtuple with the port's field names (the port's
# containers match trase_tpu's field by field; TrainState's fields are
# trase_tpu/engine/trainer.py's, as engine/trainer.py: train_state_to_numpy
# lays them out)
TRASE_TPU_CLASSES = {
    ("trase_tpu.engine.trainer", "TrainState"): _standin(
        "TrainState", ("params", "aux", "opt", "deform_vars", "deform_opt")),
    ("trase_tpu.models.gaussians", "GaussianParams"): _standin(
        "GaussianParams", G.GaussianParams._fields),
    ("trase_tpu.models.gaussians", "GaussianAux"): _standin(
        "GaussianAux", G.GaussianAux._fields),
    ("trase_tpu.models.gaussians", "GaussianOptState"): _standin(
        "GaussianOptState", G.GaussianOptState._fields),
    ("trase_tpu.engine.optim", "AdamState"): _standin(
        "AdamState", AdamState._fields),
}
_REFUSED = ("trase_tpu", "jax", "jaxlib", "flax")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        key = (module, name)
        if key in TRASE_TPU_CLASSES:
            return TRASE_TPU_CLASSES[key]
        if module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"refusing to unpickle {module}.{name}: the port reads "
                f"trase_tpu's checkpoint containers "
                f"({sorted(c for _, c in TRASE_TPU_CLASSES)}) and numpy, "
                "no other trase_tpu, jax or flax class")
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    """Unpickle a checkpoint this program or trase_tpu wrote (deform.pkl,
    chkpnt<N>.pkl), trase_tpu's containers as TRASE_TPU_CLASSES."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()
