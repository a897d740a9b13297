"""One densification round (clone, split, prune) in plain PyTorch.

What 3D Gaussian Splatting's ``GaussianModel.densify_and_prune`` does
(scene/gaussian_model.py of the method: densify_and_clone,
densify_and_split, prune_points and densification_postfix), stated over
the port's fixed-capacity layout: a table of ``capacity`` rows of which
the rows of ``alive`` are the field, where the method appends rows and
deletes them.

- A gaussian's densification gradient is its accumulated screen-space
  gradient norm over the views that saw it (accum / denom, 0 where it was
  never seen). At or above the threshold, it is cloned where its largest
  scale is at most percent_dense x the scene extent and split otherwise.
- A clone copies every field of its row. A split parent gives
  ``split_n`` children at positions R (s * n) + mu, n a standard normal
  sample, s its scales, R its rotation, each child with scales
  s / (0.8 split_n) and every other field its parent's; the parent goes.
- Then the rows whose opacity is under min_opacity are pruned and, where
  ``max_screen_size`` is given (after the first opacity reset), those whose
  largest screen radius so far is over it or whose largest scale is over
  0.1 x the extent. The statistics restart at zero everywhere; new rows
  start with zero Adam moments, the others keep theirs.

Departures from the method, each the fixed-capacity layout's:

1. At most ``max_new`` clones and ``max_new`` split parents a round,
   candidates taken in row order; the rest wait for a later round.
2. Clones go into the lowest free rows, in the order of their sources,
   and only as many as there are free rows. A split parent's first child
   takes the parent's own row; its children 1.. take the lowest rows
   still free after the clones (child c of the r-th parent the
   (r (split_n - 1) + c - 1)-th of them), and only as many parents split
   as there are free rows for all their children.
3. ``samples`` has the fixed shape (split_n, max_new, 3): the r-th split
   parent's child c takes samples[c, r].
4. Rows written in this round are not pruned in it (the method would
   prune a new row whose opacity or world size is over the limits).
5. A row that leaves the field keeps its values; only ``alive`` says it
   is gone (the method deletes it). Rows outside the field are not
   compared.

Nothing here imports the port, jax or the JAX package. ``dtype`` does the
round's arithmetic (the gradient, the scales, the opacities, the split
positions and scales) in a lower precision, copies staying copies: the
control.
"""
from __future__ import annotations

import torch

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "gaussian_features", "cluster_id")
# the fields a clone or a split child copies from its source row unchanged
COPIED = ("features_dc", "features_rest", "rotation", "opacity",
          "gaussian_features", "cluster_id")
STATS = ("max_radii2d", "xyz_gradient_accum", "denom")


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotation of (N, 4) wxyz quaternions, normalised first."""
    q = q / q.norm(dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    rows = [torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=1)]
    return torch.stack(rows, dim=1)


def densify_round(params: dict, aux: dict, moments: dict, *, extent: float,
                  max_screen_size: float, grad_threshold: float,
                  percent_dense: float, min_opacity: float, split_n: int,
                  max_new: int, samples: torch.Tensor,
                  dtype=torch.float32) -> dict:
    """One round on (params, aux with ``alive`` and STATS, moments: field
    -> (mu, nu)). Returns the new params, aux and moments, ``source`` (the
    input row each row's values came from, -1 outside the field) and the
    round's counts."""
    alive = aux["alive"]
    c = alive.shape[0]
    dev = alive.device
    max_new = min(max_new, c)
    lo = lambda t: t.to(dtype)  # noqa: E731

    grads = lo(aux["xyz_gradient_accum"]) / lo(aux["denom"])
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    max_scale = torch.exp(lo(params["scaling"])).max(dim=1).values
    high = (grads >= grad_threshold) & alive
    small = max_scale <= percent_dense * extent
    clone_cand = torch.nonzero(high & small).flatten()
    split_cand = torch.nonzero(high & ~small).flatten()
    free = torch.nonzero(~alive).flatten()

    clone_src = clone_cand[:max_new][:free.numel()]
    n_clone = clone_src.numel()
    clone_dst = free[:n_clone]
    still_free = free[n_clone:]
    per_parent = split_n - 1
    n_fit = still_free.numel() // per_parent if per_parent else max_new
    parents = split_cand[:max_new][:n_fit]
    n_split = parents.numel()

    out = {k: v.clone() for k, v in params.items()}
    source = torch.where(alive, torch.arange(c, device=dev),
                         torch.full((c,), -1, device=dev))
    for k in PARAMS:
        out[k][clone_dst] = params[k][clone_src]
    source[clone_dst] = clone_src

    stds = torch.exp(lo(params["scaling"][parents]))
    rot = rotation_matrix(lo(params["rotation"][parents]))
    child_scaling = torch.log(stds / (0.8 * split_n)).float()
    children = [parents]
    for ci in range(1, split_n):
        children.append(still_free[torch.arange(n_split, device=dev)
                                   * per_parent + (ci - 1)])
    for ci, rows in enumerate(children):
        n = lo(samples[ci, :n_split]) * stds
        xyz = torch.einsum("rij,rj->ri", rot, n) + lo(params["xyz"][parents])
        for k in COPIED:
            out[k][rows] = params[k][parents]
        out["xyz"][rows] = xyz.float()
        out["scaling"][rows] = child_scaling
        source[rows] = parents

    written = torch.zeros(c, dtype=torch.bool, device=dev)
    written[clone_dst] = True
    for rows in children:
        written[rows] = True
    alive2 = alive | written

    prune = torch.sigmoid(lo(out["opacity"][:, 0])) < min_opacity
    if max_screen_size:
        prune |= aux["max_radii2d"] > max_screen_size
        prune |= torch.exp(lo(out["scaling"])).max(dim=1).values \
            > 0.1 * extent
    prune &= alive2 & ~written
    alive3 = alive2 & ~prune
    source[~alive3] = -1

    def restart(m):
        rows = written.reshape((-1,) + (1,) * (m.ndim - 1))
        return torch.where(rows, torch.zeros_like(m), m)

    new_moments = {k: tuple(restart(m) for m in mn)
                   for k, mn in moments.items()}
    new_aux = {"alive": alive3}
    new_aux.update({k: torch.zeros_like(aux[k]) for k in STATS})
    counts = {"clone": n_clone, "split": n_split,
              "pruned": int(prune.sum()), "alive": int(alive3.sum()),
              "waiting": clone_cand.numel() - n_clone
              + split_cand.numel() - n_split}
    return {"params": out, "aux": new_aux, "moments": new_moments,
            "source": source, "counts": counts}


def compare(prog: dict, ref: dict, before: dict) -> dict:
    """The round's two numbers, program against reference.

    ``densify_rows_gap``: the rows whose ``alive`` differs, and the rows
    in the field on both sides whose copied fields (COPIED) are not
    bit for bit the reference's: a row filled from another source row, or
    left unfilled. ``densify_gap``: over the rows in the field on both
    sides, every field, statistic and Adam moment, the largest
    |program - reference| over the reference's largest magnitude of that
    field in the field (for the statistics, which restart at zero, the
    input's); 0 where both are exact. `before` is the round's input."""
    a_p, a_r = prog["aux"]["alive"], ref["aux"]["alive"]
    both = a_p & a_r
    bad = a_p != a_r
    for k in COPIED:
        same = (prog["params"][k] == ref["params"][k]).reshape(
            a_p.shape[0], -1).all(dim=1)
        bad |= both & ~same
    pairs = [(f"params.{k}", prog["params"][k], ref["params"][k],
              ref["params"][k]) for k in PARAMS]
    pairs += [(f"aux.{k}", prog["aux"][k], ref["aux"][k], before["aux"][k])
              for k in STATS]
    for k, (mu, nu) in ref["moments"].items():
        pm, pn = prog["moments"][k]
        pairs += [(f"mu.{k}", pm, mu, mu), (f"nu.{k}", pn, nu, nu)]
    worst, where = 0.0, ""
    for name, p, r, scale_of in pairs:
        rows = both.reshape((-1,) + (1,) * (r.ndim - 1)).expand_as(r)
        diff = float(torch.where(rows, (p.double() - r.double()).abs(),
                                 torch.zeros((), dtype=torch.float64,
                                             device=r.device)).max())
        scale = float(torch.where(rows, scale_of.double().abs(),
                                  torch.zeros((), dtype=torch.float64,
                                              device=r.device)).max())
        gap = diff / max(scale, 1e-30) if diff else 0.0
        if gap > worst or gap != gap:
            worst, where = gap, name
    return {"readings": {"densify_rows_gap": int(bad.sum()),
                         "densify_gap": worst},
            "worst": where}
