"""Deformation field MLPs (torch.nn).

Counterpart of trase_tpu/models/deform.py (reference utils/time_utils.py):
frequency positional encoding, an 8x256 ReLU MLP with a skip connection
after layer depth//2, heads for d_xyz (or a 6-DoF screw axis),
d_rotation (4) and d_scaling (3); the `is_blender` variant feeds time
through a small time-net (t_emb -> 256 -> 30). The variants
(Static / Dynamic / Semantic) differ in time octaves and an optional
32-dim feature input and keep the reference's registry names.

Weights written by the JAX trainer (flax variables, as numpy, in
deform/iteration_N/deform.pkl) load with ``load_flax_params``;
``flax_variables`` writes them back in that layout. ``dtype=
torch.bfloat16`` runs the hidden stack in bf16 (the GAUSSIAN training
step always does, as trase_tpu's does); parameters, the frequency
embedding and the output heads stay float32. ``deform_step(fused=True)``
runs the standard network's inference through the fused MLP kernel
(ops/mlp_cuda.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..utils.rigid import exp_se3


def frequency_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x | sin(2^0 x)..sin(2^(F-1) x) | cos(2^0 x)..cos(2^(F-1) x)].

    BLOCK order, as trase_tpu's embedder (not the reference's per-
    frequency sin/cos interleave): the first Dense layer's rows follow
    this order, so weights carried over from trase_tpu need it.
    """
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xs = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)


def embed_dim(input_dim: int, num_freqs: int) -> int:
    return input_dim * (1 + 2 * num_freqs)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax Dense(dtype=...): input, kernel and bias cast to `dtype`
    (parameters stay float32); None computes in the input's type."""
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class DeformNetwork(nn.Module):
    """Canonical-space deformation MLP: (xyz, t) -> (d_xyz, d_rot, d_scale)."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 t_multires: int = 10, is_blender: bool = False,
                 is_6dof: bool = False, feature_dim: int = 0):
        super().__init__()
        self.depth, self.width = depth, width
        self.multires, self.t_multires = multires, t_multires
        self.is_blender, self.is_6dof = is_blender, is_6dof
        self.feature_dim = feature_dim
        self.skip_at = depth // 2

        t_in = embed_dim(1, t_multires)
        if is_blender:
            self.time_net = nn.ModuleList(
                [nn.Linear(t_in, 256), nn.Linear(256, 30)])
            t_in = 30
        input_ch = embed_dim(3, multires) + t_in + feature_dim
        self.linear = nn.ModuleList()
        for i in range(depth):
            fan_in = input_ch if i == 0 else width
            if i == self.skip_at + 1:
                fan_in += input_ch  # [inp, h] after the skip layer
            self.linear.append(nn.Linear(fan_in, width))
        if is_6dof:
            self.branch_w = nn.Linear(width, 3)
            self.branch_v = nn.Linear(width, 3)
        else:
            self.gaussian_warp = nn.Linear(width, 3)
        self.gaussian_rotation = nn.Linear(width, 4)
        self.gaussian_scaling = nn.Linear(width, 3)

    def flax_order(self) -> list[nn.Linear]:
        """The Linear layers in flax's Dense_i numbering (call order)."""
        layers = list(self.time_net) if self.is_blender else []
        layers += list(self.linear)
        layers += ([self.branch_w, self.branch_v] if self.is_6dof
                   else [self.gaussian_warp])
        return layers + [self.gaussian_rotation, self.gaussian_scaling]

    def flax_names(self) -> list[str]:
        """Parameter names in flax order: Dense_i's kernel, then its
        bias, for i = 0, 1, ..."""
        names = {id(p): n for n, p in self.named_parameters()}
        return [names[id(p)] for layer in self.flax_order()
                for p in (layer.weight, layer.bias)]

    def forward(self, xyz: torch.Tensor, t: torch.Tensor,
                features: torch.Tensor | None = None, dtype=None):
        t_emb = frequency_embed(t, self.t_multires)
        if self.is_blender:
            t_emb = _dense(self.time_net[1], torch.relu(
                _dense(self.time_net[0], t_emb, dtype)), dtype).float()
        x_emb = frequency_embed(xyz, self.multires)

        parts = [x_emb, t_emb]
        if self.feature_dim:
            parts.append(features)
        inp = torch.cat(parts, dim=-1)

        h = inp
        for i, layer in enumerate(self.linear):
            h = torch.relu(_dense(layer, h, dtype))
            if i == self.skip_at:
                h = torch.cat([inp.to(h.dtype), h], dim=-1)
        h = h.float()

        if self.is_6dof:
            w = self.branch_w(h)
            v = self.branch_v(h)
            theta = torch.linalg.norm(w, dim=-1, keepdim=True)
            w = w / theta + 1e-5
            v = v / theta + 1e-5
            d_xyz = exp_se3(torch.cat([w, v], dim=-1), theta)
        else:
            d_xyz = self.gaussian_warp(h)
        return d_xyz, self.gaussian_rotation(h), self.gaussian_scaling(h)


def make_deform_network(model_type: str = "DeformNetwork",
                        is_blender: bool = False, is_6dof: bool = False,
                        device="cuda") -> DeformNetwork:
    """Registry matching the reference's DeformModelType names
    (utils/time_utils.py:398-403); variants differ in time octaves and
    the optional 32-dim feature input."""
    if model_type == "DeformNetwork":
        net = DeformNetwork(t_multires=6 if is_blender else 10,
                            is_blender=is_blender, is_6dof=is_6dof)
    elif model_type == "DeformStaticNetwork":
        net = DeformNetwork(t_multires=2, is_blender=is_blender,
                            is_6dof=is_6dof)
    elif model_type == "DeformDynamicNetwork":
        net = DeformNetwork(t_multires=32, is_blender=is_blender,
                            is_6dof=is_6dof)
    elif model_type == "DeformSemanticNetwork":
        net = DeformNetwork(t_multires=6 if is_blender else 10,
                            is_blender=is_blender, is_6dof=is_6dof,
                            feature_dim=32)
    else:
        raise ValueError(f"Unknown deform model type: {model_type}")
    return net.to(resolve_device(device))


@torch.no_grad()
def init_deform(model: DeformNetwork, generator: torch.Generator):
    """Seeded init from an explicit CPU generator: LeCun-normal kernels
    (std 1/sqrt(fan_in), flax's Dense default without its truncation)
    and zero biases. Returns the model."""
    for layer in model.flax_order():
        fan_in = layer.weight.shape[1]
        w = torch.randn(layer.weight.shape, generator=generator) / np.sqrt(fan_in)
        layer.weight.copy_(w)
        layer.bias.zero_()
    return model


@torch.no_grad()
def load_flax_params(model: DeformNetwork, variables_np) -> DeformNetwork:
    """Copy trase_tpu's flax variables ({"params": {"Dense_i": {"kernel",
    "bias"}}}, numpy arrays) into `model`. A flax Dense kernel is
    (in, out), the transpose of nn.Linear.weight. Returns the model."""
    tree = variables_np.get("params", variables_np)
    layers = model.flax_order()
    if len(tree) != len(layers):
        raise ValueError(f"flax tree has {len(tree)} Dense layers, the "
                         f"network {len(layers)}")
    for i, layer in enumerate(layers):
        p = tree[f"Dense_{i}"]
        kernel = torch.tensor(np.asarray(p["kernel"], np.float32))
        bias = torch.tensor(np.asarray(p["bias"], np.float32))
        if kernel.T.shape != layer.weight.shape:
            raise ValueError(f"Dense_{i}: kernel {tuple(kernel.shape)} does "
                             f"not fit Linear {tuple(layer.weight.shape)}")
        layer.weight.copy_(kernel.T)
        layer.bias.copy_(bias)
    return model


def flax_variables(model: DeformNetwork) -> dict:
    """The network's weights in trase_tpu's flax layout ({"params":
    {"Dense_i": {"kernel" (in, out), "bias"}}}, numpy float32): the
    inverse of load_flax_params, what deform.pkl holds."""
    return {"params": {
        f"Dense_{i}": {"kernel": lin.weight.detach().T.cpu().numpy(),
                       "bias": lin.bias.detach().cpu().numpy()}
        for i, lin in enumerate(model.flax_order())}}


def deform_step(model: DeformNetwork, xyz: torch.Tensor, t: torch.Tensor,
                features: torch.Tensor | None = None, dtype=None,
                fused: bool = False):
    """Functional `DeformModel.step` (scene/deform_model.py:34-35):
    (d_xyz, d_rotation, d_scaling) for every gaussian at time `t`;
    `dtype=torch.bfloat16` runs the hidden stack in bf16.

    `fused=True` (inference only) runs the standard architecture through
    the fused MLP (ops/mlp_cuda.py): the kernel csrc/deform_mlp.cu on
    CUDA tensors, its plain version on CPU tensors; the embedding is
    built here in float32, as trase_tpu builds it. Variants the kernel
    does not compute (fused_available) take the module path, as in
    trase_tpu."""
    if fused and features is None:
        from ..ops import mlp_cuda

        if mlp_cuda.fused_available(model):
            emb = torch.cat([frequency_embed(xyz, model.multires),
                             frequency_embed(t, model.t_multires)], dim=-1)
            fn = (mlp_cuda.fused_deform_mlp_plain
                  if emb.device.type == "cpu" else mlp_cuda.fused_deform_mlp)
            return fn(model, emb)
    if model.feature_dim:
        return model(xyz, t, features, dtype=dtype)
    return model(xyz, t, dtype=dtype)


@torch.no_grad()
def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          generator: torch.Generator | None = None,
                          start: int | None = None) -> torch.Tensor:
    """Farthest-point sampling over (N,3) -> (npoint,) int64 indices on
    xyz's device (reference utils/time_utils.py:375-396, one batch;
    trase_tpu/models/deform.py:161). The first index is `start`, or drawn
    uniformly from `generator` (trase_tpu draws it from jax.random); each
    next one is the point farthest from those taken, ties going to the
    first maximum, as jnp.argmax."""
    n = xyz.shape[0]
    if start is None:
        start = int(torch.randint(0, n, (), generator=generator))
    distance = torch.full((n,), 1e10, dtype=xyz.dtype, device=xyz.device)
    farthest = torch.tensor(start, dtype=torch.int64, device=xyz.device)
    idx = []
    for _ in range(npoint):
        idx.append(farthest)
        dist = torch.sum((xyz - xyz[farthest]) ** 2, dim=-1)
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance)
    return torch.stack(idx)
