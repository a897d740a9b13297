"""The reference NNFM style step, in plain PyTorch.

One step of the style fine-tune that docs/editing.md runs (StyleSplat,
arXiv:2407.09473, on ARF's nearest-neighbour feature matching,
arXiv:2206.06360): the deformation MLP without gradient, projection and
SH, binning and compositing of the colour (plain.py), the image clipped
to [0, 1], VGG16's conv4_1 features (Simonyan and Zisserman,
arXiv:1409.1556) of the normalized image, the NNFM loss against the
style image's conv4_1 features, its gradient in features_dc and
features_rest, then Adam on those two leaves on the styled live rows
alone. Float32 with TF32 off throughout.

- VGG16 through conv4_1 by ``F.conv2d`` (3 x 3, padding 1) and
  ``F.max_pool2d`` (2 x 2) with cuDNN off, so that no convolution is one
  of cuDNN's algorithms (the program's are).
- NNFM by its definition, in blocks of render columns, so that the
  N1 x N2 similarity is never held whole: loss = mean over render columns
  of 1 - max over style columns of their cosine; a render column whose
  max is taken by several style columns at once (a flat region of the
  style image) gives each of them an equal share of its gradient. The
  gradient in the render's features is worked out here from that rule,
  not by differentiating a library's max.

Departures from the published method, each as the style CLI runs it:

- the VGG16 weights are seeded draws, not ImageNet's: He-normal kernels
  (std sqrt(2 / (9 fan-in))) from ``np.random.default_rng(seed)``, block
  by block and conv by conv, with zero biases (no pretrained file can be
  bundled; the port's models/vgg.py draws the same);
- the image is normalized by ImageNet's statistics twice, once outside
  the extractor and once inside it, as the CLI feeds it;
- the features are conv4_1's before its ReLU (the CLI's ``conv4_1``);
- the clip passes half the cotangent at a bound (jnp.clip's rule, which
  the program keeps): ``minimum(maximum(x, 0), 1)``;
- the deformation MLP's hidden stack runs in bfloat16, as the recipe
  runs it; it takes no gradient.

``tf32`` (the control) lets the VGG's and the NNFM's products run in
TF32; ``fault`` plants ``half_rows`` (half the styled rows updated) or
``double`` (the features_dc update taken twice).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import plain as P

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# VGG16 up to conv4_1: (in, out) of each conv, "pool" for a 2 x 2 max-pool
VGG16_TO_CONV4_1 = [(3, 64), (64, 64), "pool", (64, 128), (128, 128), "pool",
                    (128, 256), (256, 256), (256, 256), "pool", (256, 512)]
ROW_BLOCK = 2048
LEAVES = ("features_dc", "features_rest")


def vgg_weights(seed: int, device) -> list:
    """[(w, b)] of each conv through conv4_1, drawn as the module
    docstring says."""
    rng = np.random.default_rng(seed)
    out = []
    for layer in VGG16_TO_CONV4_1:
        if layer == "pool":
            continue
        cin, cout = layer
        w = rng.normal(0, np.sqrt(2.0 / (cin * 9)),
                       size=(cout, cin, 3, 3)).astype(np.float32)
        out.append((torch.from_numpy(w).to(device),
                    torch.zeros(cout, device=device)))
    return out


@contextlib.contextmanager
def _precision(tf32: bool):
    """Float32 products, or TF32 ones (the control)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def normalize(image: torch.Tensor) -> torch.Tensor:
    dev = image.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(3, 1, 1)
    return (image - mean) / std


def vgg_conv4_1(weights: list, image: torch.Tensor,
                tf32: bool = False) -> torch.Tensor:
    """(512, H / 8, W / 8): conv4_1 (before its ReLU) of the (3, H, W)
    image in [0, 1], normalized twice."""
    x = normalize(normalize(image))[None]
    convs = iter(weights)
    with torch.backends.cudnn.flags(enabled=False), _precision(tf32):
        pre = None
        for layer in VGG16_TO_CONV4_1:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            w, b = next(convs)
            pre = F.conv2d(x, w, b, padding=1)
            x = torch.relu(pre)
    return pre[0]


def unit_columns(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=0, keepdim=True)) + 1e-12)


def nnfm(feat1: torch.Tensor, feat2: torch.Tensor, tf32: bool = False,
         block: int = ROW_BLOCK) -> tuple[float, torch.Tensor]:
    """(loss, its gradient in feat1) of NNFM on (C, N1) render features
    against (C, N2) style features (module docstring)."""
    f1 = feat1.detach().requires_grad_(True)
    with torch.enable_grad():
        u1 = unit_columns(f1)
    u2 = unit_columns(feat2.detach())
    n1 = f1.shape[1]
    total = 0.0
    g_u1 = torch.empty_like(u1)
    with torch.no_grad(), _precision(tf32):
        for lo in range(0, n1, block):
            sim = u1[:, lo:lo + block].T @ u2  # (b, N2)
            best = sim.max(dim=1).values
            total += float((1.0 - best).double().sum())
            tied = (sim == best[:, None]).to(sim.dtype)
            share = tied / tied.sum(dim=1, keepdim=True)
            # d(1 - max_j sim_ij) / d u1_i = -mean of the tied u2_j
            g_u1[:, lo:lo + block] = -(u2 @ share.T) / n1
    (g,) = torch.autograd.grad(u1, [f1], g_u1)
    return total / n1, g


def clip_unit(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.ones_like(x))


def step_loss_and_grads(params: dict, alive, deform: list, vgg: list,
                        style_feats: torch.Tensor, step: dict,
                        deform_cfg: dict, bg, tf32: bool = False):
    """(loss, {leaf: gradient}) of one style step: the colour render of
    the step's view, the NNFM of its conv4_1 features against
    `style_feats`, differentiated in features_dc and features_rest."""
    dev = params["xyz"].device
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    fields = {k: params[k].detach() for k in ("xyz", "scaling", "rotation",
                                              "opacity")}
    fields.update(leaves)
    n = fields["xyz"].shape[0]
    with torch.no_grad():
        t = torch.zeros((n, 1), device=dev) \
            + torch.tensor(float(step["fid"]), device=dev)
        d = P.deform_mlp(deform, fields["xyz"], t, deform_cfg["D"],
                         deform_cfg["multires"], deform_cfg["t_multires"],
                         hidden_dtype=torch.bfloat16)
    view = step["view"]
    H, W = view.height, view.width
    g = P.deformed_gaussians(fields, alive, *d)
    proj = P.project(view, *g, sh_degree=step["sh_degree"])
    bins = P.bin_pairs(proj, H, W, step["K"])
    mean2d, conic, logop, vals = P.payload_of(proj)
    geometry = [x.detach() for x in (mean2d, conic, logop)]
    vals_in = vals.detach().requires_grad_(True)
    with torch.no_grad():
        hwc = P.composite(bins, *geometry, vals_in, H, W)
    hwc = hwc.detach().requires_grad_(True)
    with torch.enable_grad():
        acc = hwc[..., 0]
        rgb = hwc[..., 1:4] + (1.0 - acc)[..., None] * bg[None, None, :]
        feats = vgg_conv4_1(vgg, clip_unit(rgb.permute(2, 0, 1)), tf32)
        flat = feats.reshape(feats.shape[0], -1)
    loss, g_flat = nnfm(flat, style_feats, tf32)
    (g_hwc,) = torch.autograd.grad(flat, [hwc], g_flat)
    P.composite(bins, *geometry, vals_in, H, W, grad_out=g_hwc)
    grads = torch.autograd.grad(vals, list(leaves.values()), vals_in.grad)
    return loss, dict(zip(LEAVES, grads))


def run_steps(params: dict, alive, deform: list, vgg: list,
              style_feats: torch.Tensor, row_mask, steps: list,
              deform_cfg: dict, recipe: dict, bg, tf32: bool = False,
              fault: str | None = None):
    """Follow the program through `steps` (dicts of view, fid, K,
    sh_degree) from fresh Adam moments, the rows of `row_mask` (the
    styled live ones) alone changing. Returns the losses, the first
    step's gradients as the optimizer gets them (other rows' dropped) and
    the two leaves after the last step."""
    if fault == "half_rows":
        rows = torch.nonzero(row_mask).flatten()
        row_mask = row_mask.clone()
        row_mask[rows[1::2]] = False
    lrs = {"features_dc": recipe["feature_lr"],
           "features_rest": recipe["feature_lr"] / 20.0}
    p = {k: params[k].clone() for k in LEAVES}
    mom = {k: [torch.zeros_like(p[k]), torch.zeros_like(p[k])] for k in LEAVES}
    losses, first = [], None
    for i, step in enumerate(steps, start=1):
        loss, grads = step_loss_and_grads(dict(params, **p), alive, deform,
                                          vgg, style_feats, step, deform_cfg,
                                          bg, tf32)
        losses.append(loss)
        if first is None:
            first = {k: torch.where(
                row_mask.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                torch.zeros_like(g)) for k, g in grads.items()}
        with torch.no_grad():
            for k in LEAVES:
                new, m1, m2 = P.adam(p[k], grads[k], *mom[k], i, lrs[k],
                                     row_mask=row_mask)
                if fault == "double" and k == "features_dc":
                    new = p[k] + 2.0 * (new - p[k])
                p[k], mom[k] = new, [m1, m2]
    return losses, first, p
