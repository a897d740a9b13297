"""The reference FEATURE training step, in plain PyTorch.

One step of the segmentation feature field, after densification (the
compositor differentiates the features alone): the deformation MLP
without gradient (bf16 stack), the 32 features of every gaussian
normalized, smoothed over a subset of their 16 nearest neighbours (the
subset the step drew) and normalized again, composited with the
gaussians' geometry as [acc | features] (the features rounded to bf16,
as the configuration composites them), then the method's SAM-mask
contrastive loss on the sampled pixels (soft pair mining, mask-size pair
weights) plus rfn (1 - mean |F|)^2, its gradient in the raw features, and
Adam on them (dead rows frozen).

The neighbour map is worked out here (exact KNN, self included), and so
are the step's pixel and mask sample and neighbour slots, drawn again
from a generator in the state the step found its own. From each step's
call it takes the view and that generator state. ``dtype`` runs projection, compositing
and the loss in a lower precision (the control); ``fault`` plants
``half_batch`` (half the sampled pixels left out) or ``double`` (the
update taken twice).
"""
from __future__ import annotations

import torch

from . import plain as P


def knn_map(xyz: torch.Tensor, k: int, chunk: int = 4096) -> torch.Tensor:
    """(N, k) indices of each point's k nearest points, itself included,
    by squared distance |q|^2 + |p|^2 - 2 q.p (float32, no TF32)."""
    sq = (xyz * xyz).sum(dim=1)
    out = []
    for lo in range(0, xyz.shape[0], chunk):
        q = xyz[lo:lo + chunk]
        d2 = torch.clamp((q * q).sum(dim=1, keepdim=True) + sq[None, :]
                         - 2.0 * (q @ xyz.T), min=0.0)
        out.append(torch.topk(d2, k=k, dim=1, largest=False).indices)
    return torch.cat(out)


def unit_rows(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True) + 1e-12)


def correspondence(masks: torch.Tensor, sample: dict) -> torch.Tensor:
    """C[h, j] = 1 where a selected mask holds both sampled pixels."""
    m = masks.shape[0]
    v = masks.reshape(m, -1)[:, sample["pixel_idx"]].float()
    v = v * sample["mask_sel"][:, None].float()
    return ((v.T @ v) != 0).float()


def pair_weights(masks: torch.Tensor, sample: dict) -> torch.Tensor:
    """Pair weights in [1, 10] from the mean size of the masks holding
    each sampled pixel."""
    m = masks.shape[0]
    flat = masks.float().reshape(m, -1)
    sizes = flat.sum(dim=1)
    mean_size = ((flat * sizes[:, None]).sum(dim=0)
                 / (flat.sum(dim=0) + 1e-9))[sample["pixel_idx"]]
    ptp = mean_size[None, :] * mean_size[:, None]
    top = ptp.max()
    ptp = torch.where(ptp == 0, torch.full_like(ptp, 1e10), ptp)
    w = torch.clamp(top / ptp, min=1.0)
    return (w - w.min()) / (w.max() - w.min() + 1e-12) * 9.0 + 1.0


def soft_losses(C, C_F, valid, weights, positive_th: float,
                negative_th: float):
    """The soft positive and negative pair losses: over the valid pairs
    above the diagonal, in columns holding at least one hard pair of the
    kind, the weighted -C_F of positive pairs and relu(C_F) of negative
    ones, each over its count of pairs."""
    triu = torch.ones(C.shape, dtype=torch.bool, device=C.device).triu(1)
    pairs = valid[:, None] & valid[None, :] & triu

    def one(values, kind, hard):
        col = torch.any(hard & (C == kind), dim=0)
        count = pairs & col[None, :]
        sel = count & (C == kind)
        num = torch.where(sel, values * weights,
                          torch.zeros_like(values)).sum()
        loss = num / torch.clamp(count.sum(), min=1)
        return torch.where(sel.sum() == 0, torch.zeros_like(loss), loss)

    return (one(-C_F, 1, C_F < positive_th),
            one(torch.relu(C_F), 0, C_F > negative_th))


def draw(state, masks: torch.Tensor, recipe: dict, k: int):
    """The step's random draws, from a generator in the state the step
    found it: the pixel sample (the pixels of the masks' union, exactly
    num_sampled_pixels by random-score top-k, slots past the union's size
    invalid), each mask selected with probability num_sampled_masks / M,
    then the smoothing's neighbour slots (the first half of a permutation
    of the k slots)."""
    g = torch.Generator(device=masks.device)
    g.set_state(state)
    m, h, w = masks.shape
    in_any = (masks.sum(dim=0) > 0).reshape(-1)
    scores = torch.rand(h * w, generator=g, device=masks.device)
    scores = torch.where(in_any, scores, torch.full_like(scores,
                                                         float("inf")))
    neg_top, idx = torch.topk(-scores, int(recipe["num_sampled_pixels"]))
    rate = recipe["num_sampled_masks"] / m
    sel = torch.rand(m, generator=g, device=masks.device) < rate
    slots = torch.randperm(k, generator=g, device=masks.device)[
        :max(int(k * 0.5), 1)]
    return {"pixel_idx": idx, "pixel_valid": torch.isfinite(-neg_top),
            "mask_sel": sel}, slots


def step_loss_and_grad(params: dict, alive, weights: list, nbr, step: dict,
                       deform_cfg: dict, recipe: dict, dtype=torch.float32,
                       fault: str | None = None):
    """(loss, gradient of the raw features)."""
    view = step["view"]
    feat = params["gaussian_features"].detach().requires_grad_(True)
    xyz = params["xyz"]
    n = xyz.shape[0]
    with torch.no_grad():
        t = torch.zeros((n, 1), device=xyz.device) \
            + torch.tensor(float(step["fid"]), device=xyz.device)
        d = P.deform_mlp(weights, xyz, t, deform_cfg["D"],
                         deform_cfg["multires"], deform_cfg["t_multires"],
                         hidden_dtype=torch.bfloat16)
        g = P.deformed_gaussians(params, alive, *d)
        proj = P.project(view, *g, sh_degree=step["sh_degree"], dtype=dtype)
        bins = P.bin_pairs(proj, view.height, view.width, step["K"])
        mean2d, conic, logop, _ = P.payload_of(proj)
    masks = step["masks"]
    sample, slots = draw(step["generator_state"], masks, recipe,
                         nbr.shape[1])
    f = unit_rows(feat)[nbr[:, slots]].mean(dim=1)
    f = unit_rows(f)
    # composited at bf16 (round to nearest even); the gradient passes
    f = f + (f.to(torch.bfloat16).float() - f).detach()
    valid = proj["valid"][:, None]
    vals = torch.where(valid, f.to(dtype), torch.zeros((), dtype=dtype,
                                                        device=f.device))
    vleaf = vals.detach().requires_grad_(True)
    with torch.no_grad():
        hwc = P.composite(bins, mean2d, conic, logop, vleaf, view.height,
                          view.width)
    hwc = hwc.detach().requires_grad_(True)
    sq = torch.sum(hwc * hwc, dim=-1) - hwc[..., 0] * hwc[..., 0]
    rf_norm = torch.sqrt(torch.clamp(sq, min=0.0) + 1e-12).mean()
    pvalid = sample["pixel_valid"]
    if fault == "half_batch":
        pvalid = pvalid & (torch.arange(pvalid.numel(), device=pvalid.device)
                           < pvalid.numel() // 2)
    C = correspondence(masks, sample)
    w = pair_weights(masks, sample)
    s = hwc.reshape(-1, hwc.shape[-1])[sample["pixel_idx"]][:, 1:]
    s = s / torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True) + 1e-12)
    C_F = s @ s.T
    pos, neg = soft_losses(C, C_F, pvalid, w, recipe["hard_positive_th"],
                           recipe["hard_negative_th"])
    loss = pos + neg + recipe["rfn"] * (1.0 - rf_norm) ** 2
    (g_hwc,) = torch.autograd.grad(loss, [hwc])
    P.composite(bins, mean2d, conic, logop, vleaf, view.height, view.width,
                grad_out=g_hwc)
    (grad,) = torch.autograd.grad(vals, [feat], vleaf.grad)
    return float(loss.detach()), grad.float()


def run_steps(params: dict, alive, weights: list, steps: list,
              deform_cfg: dict, recipe: dict, dtype=torch.float32,
              fault: str | None = None):
    """Follow the program through `steps` from fresh Adam moments:
    (losses, the first gradient, the features after the last step)."""
    nbr = knn_map(params["xyz"], int(recipe["smooth_K"]))
    p = dict(params)
    mu = torch.zeros_like(p["gaussian_features"])
    nu = torch.zeros_like(mu)
    losses, first = [], None
    for i, step in enumerate(steps, start=1):
        loss, g = step_loss_and_grad(p, alive, weights, nbr, step,
                                     deform_cfg, recipe, dtype, fault)
        losses.append(loss)
        if first is None:
            # as the optimizer gets it: dead rows' gradients are dropped
            first = torch.where(alive[:, None], g, torch.zeros_like(g))
        with torch.no_grad():
            old = p["gaussian_features"]
            new, mu, nu = P.adam(old, g, mu, nu, i, recipe["feature_lr"],
                                 row_mask=alive)
            if fault == "double":
                new = old + 2.0 * (new - old)
            p["gaussian_features"] = new
    return losses, first, p["gaussian_features"]
