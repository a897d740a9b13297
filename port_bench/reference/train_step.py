"""The reference GAUSSIAN training step, in plain PyTorch.

One step: the deformation MLP (hidden stack in the recipe's bfloat16)
on the canonical centres at the view's time, projection and SH, binning,
compositing, L = (1 - l) L1 + l (1 - SSIM), gradients by autograd (the
compositor's by chunked recomputation), then Adam on the six gaussian
fields (dead rows frozen) and on every tensor of the MLP. Before the
recipe's ``warm_up`` the method holds the MLP off: a step whose
``use_deform`` is false adds no deltas and neither differentiates nor
updates the MLP. The learning rates are worked out here from the recipe.

Each step also accumulates the densification statistics the method keeps
(add_densification_stats): for the live gaussians the view saw, the norm
of the screen-space position gradient in NDC units (pixels x W/2, H/2),
a count of views, and the largest screen radius.

``dtype`` runs projection, compositing and the loss in a lower precision
(the control); ``fault`` plants one of the faults the check has to see
(``half_batch``: the loss over the top half of the image; ``double``: the
opacity update taken twice).
"""
from __future__ import annotations

import torch

from . import plain as P

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")


def learning_rates(recipe: dict, iteration: int) -> dict:
    """The recipe's learning rates at `iteration` (spatial scale 5, as
    the method hard-codes it)."""
    s = 5.0
    return {
        "xyz": P.expon_lr(iteration, recipe["position_lr_init"] * s,
                          recipe["position_lr_final"] * s,
                          recipe["position_lr_delay_mult"],
                          recipe["position_lr_max_steps"]),
        "deform": P.expon_lr(iteration, recipe["position_lr_init"] * s,
                             recipe["position_lr_final"],
                             recipe["position_lr_delay_mult"],
                             recipe["deform_lr_max_steps"]),
        "features_dc": recipe["feature_lr"],
        "features_rest": recipe["feature_lr"] / 20.0,
        "opacity": recipe["opacity_lr"],
        "scaling": recipe["scaling_lr"],
        "rotation": recipe["rotation_lr"],
    }


def step_loss_and_grads(params: dict, alive, weights: list, step: dict,
                        deform_cfg: dict, lambda_dssim: float, bg,
                        dtype=torch.float32, fault: str | None = None):
    """(loss, grads of the six fields, grads of the MLP tensors, the
    screen: the position gradient in pixels and the radius, 0 where the
    view does not see a gaussian)."""
    use_deform = bool(step.get("use_deform", True))
    leaves = {k: params[k].detach().requires_grad_(True) for k in FIELDS}
    wl = [w.detach().requires_grad_(use_deform) for w in weights]
    xyz = leaves["xyz"]
    n = xyz.shape[0]
    if use_deform:
        t = torch.zeros((n, 1), device=xyz.device) \
            + torch.tensor(float(step["fid"]), device=xyz.device) \
            + torch.tensor(float(step["ast"]), device=xyz.device)
        d_xyz, d_rot, d_scale = P.deform_mlp(
            wl, xyz.detach(), t, deform_cfg["D"], deform_cfg["multires"],
            deform_cfg["t_multires"], hidden_dtype=torch.bfloat16)
    else:
        d_xyz = d_rot = d_scale = 0.0
    g = P.deformed_gaussians(leaves, alive, d_xyz, d_rot, d_scale)
    view = step["view"]
    proj = P.project(view, *g, sh_degree=step["sh_degree"], dtype=dtype)
    bins = P.bin_pairs(proj, view.height, view.width, step["K"])
    mean2d, conic, logop, vals = P.payload_of(proj)
    inputs = [x.detach().requires_grad_(True)
              for x in (mean2d, conic, logop, vals)]
    with torch.no_grad():
        hwc = P.composite(bins, *inputs, view.height, view.width)
    hwc = hwc.detach().requires_grad_(True)
    acc = hwc[..., 0]
    rgb = hwc[..., 1:4] + (1.0 - acc)[..., None] * bg.to(dtype)[None, None, :]
    image = rgb.permute(2, 0, 1)
    gt = step["gt"].to(dtype)
    if fault == "half_batch":
        h = view.height // 2
        image, gt = image[:, :h], gt[:, :h]
    l1 = torch.abs(image - gt).mean()
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - P.ssim(image, gt))
    (g_hwc,) = torch.autograd.grad(loss, [hwc])
    P.composite(bins, *inputs, view.height, view.width, grad_out=g_hwc)
    pay_grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                 for x in inputs]
    outs = [mean2d, conic, logop, vals]
    trained = list(leaves.values()) + (wl if use_deform else [])
    grads = torch.autograd.grad(outs, trained, pay_grads, allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr.float()
             for x, gr in zip(trained, grads)]
    if not use_deform:
        grads += [torch.zeros_like(w) for w in wl]
    screen = (pay_grads[0].float(), proj["radius"].detach().float())
    return float(loss.detach()), dict(zip(FIELDS, grads[:len(FIELDS)])), \
        grads[len(FIELDS):], screen


def add_stats(stats: dict, screen, alive, height: int, width: int) -> dict:
    """The densification statistics after one more view: `screen` is
    step_loss_and_grads' (pixel gradient, radius)."""
    g, radius = screen
    seen = (radius > 0) & alive
    ndc = g * torch.tensor([width / 2.0, height / 2.0], device=g.device)
    norm = torch.hypot(ndc[:, 0], ndc[:, 1])
    return {"xyz_gradient_accum": stats["xyz_gradient_accum"]
            + torch.where(seen, norm, torch.zeros_like(norm)),
            "denom": stats["denom"] + seen.float(),
            "max_radii2d": torch.where(
                seen, torch.maximum(stats["max_radii2d"], radius),
                stats["max_radii2d"])}


def run_steps(params: dict, alive, weights: list, steps: list,
              deform_cfg: dict, recipe: dict, bg, dtype=torch.float32,
              fault: str | None = None):
    """Follow the program through `steps` (dicts of view, gt, fid, ast,
    K, sh_degree, use_deform, iteration) from fresh Adam moments and
    statistics. Returns the losses, the first step's gradients (fields,
    MLP), the parameters after the last step (fields, MLP) and the
    densification statistics then."""
    p = {k: params[k].clone() for k in FIELDS}
    w = [x.clone() for x in weights]
    mom = {k: [torch.zeros_like(p[k]), torch.zeros_like(p[k])] for k in FIELDS}
    wmom = [[torch.zeros_like(x), torch.zeros_like(x)] for x in w]
    zeros = torch.zeros(alive.shape[0], device=alive.device)
    stats = {k: zeros.clone() for k in ("xyz_gradient_accum", "denom",
                                        "max_radii2d")}
    losses, first, w_steps = [], None, 0
    for i, step in enumerate(steps, start=1):
        loss, gf, gw, screen = step_loss_and_grads(
            p, alive, w, step, deform_cfg, recipe["lambda_dssim"], bg, dtype,
            fault)
        losses.append(loss)
        view = step["view"]
        stats = add_stats(stats, screen, alive, view.height, view.width)
        if first is None:
            # as the optimizer gets it: dead rows' gradients are dropped
            first = ({k: torch.where(alive.reshape((-1,) + (1,) * (g.ndim - 1)),
                                     g, torch.zeros_like(g))
                      for k, g in gf.items()}, gw)
        lrs = learning_rates(recipe, step["iteration"])
        with torch.no_grad():
            for k in FIELDS:
                new, m1, m2 = P.adam(p[k], gf[k], *mom[k], i, lrs[k],
                                     row_mask=alive)
                if fault == "double" and k == "opacity":
                    new = p[k] + 2.0 * (new - p[k])
                p[k], mom[k] = new, [m1, m2]
            if not step.get("use_deform", True):
                continue
            w_steps += 1
            for j in range(len(w)):
                w[j], m1, m2 = P.adam(w[j], gw[j], *wmom[j], w_steps,
                                      lrs["deform"])
                wmom[j] = [m1, m2]
    return losses, first, (p, w), stats
