"""Import the reference PyTorch checkpoints (`deform.pth`, `chkpnt<N>.pth`).

Counterpart of trase_tpu/tools/import_torch.py. The reference saves
``torch.save(deform.deform.state_dict(), ...)`` at
``deform/iteration_N/deform.pth`` (scene/deform_model.py:50-57) and
``torch.save((gaussians.capture(), iteration), ...)`` at
``chkpnt<N>.pth`` (train.py:396); a user moving from the reference
brings both along. The deform weights map onto trase_tpu's flax layout,
which the port keeps (``models/deform.py: flax_names``,
``load_flax_params``):

- torch ``nn.Linear`` stores weight (out, in); a flax kernel is
  (in, out): transposed.
- The reference's frequency embedding interleaves sin/cos per octave
  ([x | sin(f0)D | cos(f0)D | sin(f1)D | ...], utils/time_utils.py:
  44-52); trase_tpu's and the port's is block-ordered ([x | all sins |
  all coses]). The first Dense of the stack (and the skip Dense's input
  rows, and the blender timenet's first Dense) absorb the difference by
  a row permutation of their kernels.
- Layer names (reference utils/time_utils.py:60-132 -> Dense_i in trace
  order): blender timenet.0/.2 first when present, then linear.0..D-1,
  then gaussian_warp (or branch_w / branch_v when is_6dof),
  gaussian_rotation, gaussian_scaling.

A reference ``chkpnt<N>.pth`` carries the gaussian field and its Adam
state, not the deform weights (the reference's restore omits them too):
bring those from a snapshot's deform.pth through ``import_deform_pth``.

    python -m trase_tpu_torch.tools.import_torch -i deform.pth -o deform.pkl
    python -m trase_tpu_torch.tools.import_torch --kind chkpnt \\
        -i chkpnt30000.pth -o chkpnt30000.pkl
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def _embed_perm(d: int, f: int) -> np.ndarray:
    """perm[our_pos] = ref_pos for one frequency embedding block."""
    perm = np.zeros(d * (1 + 2 * f), np.int64)
    perm[:d] = np.arange(d)
    for k in range(f):
        for c in range(2):  # 0 = sin, 1 = cos
            for dd in range(d):
                ref = d + k * 2 * d + c * d + dd
                ours = d + c * f * d + k * d + dd
                perm[ours] = ref
    return perm


def _input_perm(multires: int, t_multires: int, is_blender: bool,
                feature_dim: int) -> np.ndarray:
    """Row permutation of the full MLP input [x_emb | t | (features)]."""
    px = _embed_perm(3, multires)
    parts = [px]
    off = len(px)
    if is_blender:
        parts.append(off + np.arange(30))  # timenet output: identity
        off += 30
    else:
        pt = _embed_perm(1, t_multires)
        parts.append(off + pt)
        off += len(pt)
    if feature_dim:
        parts.append(off + np.arange(feature_dim))
    return np.concatenate(parts)


def _np32(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                      else v, np.float32)


def import_deform_state_dict(sd: dict, *, multires: int = 10,
                             t_multires: int = 10, depth: int = 8,
                             is_blender: bool = False,
                             is_6dof: bool = False,
                             feature_dim: int = 0) -> dict:
    """Reference DeformNetwork state_dict -> flax-layout
    ``{"params": {"Dense_i": {"kernel" (in, out), "bias"}}}`` (numpy)."""
    def arr(k):
        return _np32(sd[k])

    def linear(prefix, row_perm=None):
        w = arr(f"{prefix}.weight").T  # (in, out)
        if row_perm is not None:
            w = w[row_perm]
        return {"kernel": w, "bias": arr(f"{prefix}.bias")}

    inp_perm = _input_perm(multires, t_multires, is_blender, feature_dim)
    in_ch = len(inp_perm)
    params = {}
    i = 0
    if is_blender:
        params[f"Dense_{i}"] = linear("timenet.0",
                                      _embed_perm(1, t_multires))
        i += 1
        params[f"Dense_{i}"] = linear("timenet.2")
        i += 1
    skip_at = depth // 2
    for layer in range(depth):
        name = f"linear.{layer}"
        if layer == 0:
            params[f"Dense_{i}"] = linear(name, inp_perm)
        elif layer == skip_at + 1:
            # skip layer input = [inp | h]: permute only the inp rows
            w = arr(f"{name}.weight").T
            perm = np.concatenate(
                [inp_perm, in_ch + np.arange(w.shape[0] - in_ch)])
            params[f"Dense_{i}"] = {"kernel": w[perm],
                                    "bias": arr(f"{name}.bias")}
        else:
            params[f"Dense_{i}"] = linear(name)
        i += 1
    heads = (["branch_w", "branch_v"] if is_6dof else ["gaussian_warp"])
    heads += ["gaussian_rotation", "gaussian_scaling"]
    for h in heads:
        params[f"Dense_{i}"] = linear(h)
        i += 1
    return {"params": params}


def import_deform_pth(path: str, *, model_type: str = "DeformNetwork",
                      is_blender: bool = False,
                      is_6dof: bool = False) -> dict:
    """A reference deform.pth -> the payload of deform.pkl
    ({"vars": flax-layout variables, "type": model_type})."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    t_multires = {"DeformNetwork": 6 if is_blender else 10,
                  "DeformStaticNetwork": 2,
                  "DeformDynamicNetwork": 32,
                  "DeformSemanticNetwork": 6 if is_blender else 10}[
                      model_type]
    feature_dim = 32 if model_type == "DeformSemanticNetwork" else 0
    variables = import_deform_state_dict(
        sd, t_multires=t_multires, is_blender=is_blender,
        is_6dof=is_6dof, feature_dim=feature_dim)
    return {"vars": variables, "type": model_type}


def _adam_state_for(opt_sd: dict | None, group_name: str,
                    param: torch.Tensor, n_expected: int):
    """torch.optim.Adam state_dict -> the port's AdamState(mu, nu, step)
    for the named param group, on param's device; zeros when the state
    is absent (a param the reference never stepped has no entry)."""
    from ..engine.optim import AdamState, adam_init

    if opt_sd is None:
        return adam_init(param)
    # param_groups[i]["params"] are integer ids into state{}
    for g in opt_sd.get("param_groups", []):
        if g.get("name") != group_name:
            continue
        for pid in g["params"]:
            st = opt_sd.get("state", {}).get(pid)
            if st is None:
                break
            mu, nu = _np32(st["exp_avg"]), _np32(st["exp_avg_sq"])
            if mu.shape[0] != n_expected:
                break
            # the layouts may differ (gaussian_features is (n, 32) here,
            # (n, 1, 32) in the reference): the moments take the param's
            # shape, or Adam would broadcast them against it
            shape = tuple(param.shape)
            if mu.size != int(np.prod(shape)):
                break
            step = st.get("step", 0)
            step = int(step.item() if hasattr(step, "item") else step)

            def t(x):
                return torch.tensor(x.reshape(shape), device=param.device)

            return AdamState(mu=t(mu), nu=t(nu),
                             step=torch.tensor(step, dtype=torch.int32,
                                               device=param.device))
    return adam_init(param)


def import_gaussian_capture(model_args, *, capacity: int | None = None,
                            device="cuda"):
    """Reference ``gaussians.capture()`` 13-tuple -> (params, aux, opt,
    meta) in the port's fixed-capacity layout on `device`
    (scene/gaussian_model.py:106-140).

    The reference's own ``capture`` predates its dual-optimizer refactor
    (``self.optimizer`` is a {"GAUSSIAN", "FEATURE"} dict at
    scene/gaussian_model.py:286-289, so ``.state_dict()`` raises); all
    three shapes found in the wild are accepted: a single torch Adam
    state_dict (upstream Deformable-3DGS checkpoints), a dict of two
    state_dicts, or None.
    """
    from ..models import gaussians as G

    dev = resolve_device(device)
    (active_sh_degree, xyz, f_dc, f_rest, scaling, rotation, opacity,
     gaussian_features, max_radii2d, xyz_grad_accum, denom, opt_sd,
     spatial_lr_scale) = model_args

    def t(v, shape=None):
        x = _np32(v)
        return torch.tensor(x if shape is None else x.reshape(shape),
                            device=dev)

    n = _np32(xyz).shape[0]
    params = G.GaussianParams(
        xyz=t(xyz), features_dc=t(f_dc), features_rest=t(f_rest),
        scaling=t(scaling), rotation=t(rotation), opacity=t(opacity),
        gaussian_features=t(gaussian_features, (n, -1)),
        cluster_id=torch.full((n, 1), -1.0, device=dev))
    aux = G.GaussianAux(
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        max_radii2d=t(max_radii2d, (n,)),
        xyz_gradient_accum=t(xyz_grad_accum, (n,)),
        denom=t(denom, (n,)))
    # normalise the three optimizer shapes to {group_name: state_dict}
    g_sd = f_sd = None
    if isinstance(opt_sd, dict):
        if "GAUSSIAN" in opt_sd or "FEATURE" in opt_sd:
            g_sd, f_sd = opt_sd.get("GAUSSIAN"), opt_sd.get("FEATURE")
        elif "param_groups" in opt_sd:
            g_sd = f_sd = opt_sd
    opt = G.GaussianOptState(
        xyz=_adam_state_for(g_sd, "xyz", params.xyz, n),
        features_dc=_adam_state_for(g_sd, "f_dc", params.features_dc, n),
        features_rest=_adam_state_for(g_sd, "f_rest",
                                      params.features_rest, n),
        scaling=_adam_state_for(g_sd, "scaling", params.scaling, n),
        rotation=_adam_state_for(g_sd, "rotation", params.rotation, n),
        opacity=_adam_state_for(g_sd, "opacity", params.opacity, n),
        gaussian_features=_adam_state_for(
            f_sd, "gaussian_feats", params.gaussian_features, n),
    )
    if capacity is None:
        capacity = G.default_capacity(n)
    if capacity > n:
        params, aux, opt = G.grow_capacity(params, aux, opt, capacity)
    meta = {
        "active_sh_degree": int(active_sh_degree),
        "spatial_lr_scale": float(spatial_lr_scale),
        "n_alive": n,
    }
    return params, aux, opt, meta


def import_chkpnt_pth(path: str, *, capacity: int | None = None,
                      device="cuda"):
    """Load a reference ``chkpnt<N>.pth`` (``torch.save((capture(),
    iteration), ...)``, train.py:396) into the port's state layout:
    (params, aux, opt, meta) with meta["iteration"]. The file holds no
    deform weights."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    model_args, iteration = payload
    params, aux, opt, meta = import_gaussian_capture(
        model_args, capacity=capacity, device=device)
    meta["iteration"] = int(iteration)
    return params, aux, opt, meta


def main(argv=None):
    """Convert a reference checkpoint into the port's format: deform.pth
    -> deform.pkl (what the render CLI and the trainer read), chkpnt<N>.pth
    -> a pickle of numpy dicts {params, aux, opt ({field: {mu, nu,
    step}}), meta}. A chkpnt's field is assembled on --device (default
    cuda); the deform conversion is numpy alone."""
    import argparse

    from ..models.gaussians_io import save_checkpoint

    ap = argparse.ArgumentParser(
        description="Convert reference torch checkpoints "
                    "(deform.pth / chkpntN.pth) to the port's formats")
    ap.add_argument("--input", "-i", required=True)
    ap.add_argument("--output", "-o", required=True)
    ap.add_argument("--kind", choices=["deform", "chkpnt"],
                    default="deform")
    ap.add_argument("--model_type", default="DeformNetwork")
    ap.add_argument("--is_blender", action="store_true")
    ap.add_argument("--is_6dof", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where --kind chkpnt assembles the field: cuda "
                         "(the card, default) or cpu")
    args = ap.parse_args(argv)
    if args.kind == "chkpnt":
        params, aux, opt, meta = import_chkpnt_pth(args.input,
                                                   device=args.device)
        save_checkpoint(args.output, {
            "params": params._asdict(), "aux": aux._asdict(),
            "opt": {k: s._asdict() for k, s in opt._asdict().items()},
            "meta": meta})
        print(f"{args.input} -> {args.output} "
              f"(iteration {meta['iteration']}, {meta['n_alive']} "
              f"gaussians, sh_degree {meta['active_sh_degree']})")
        return
    payload = import_deform_pth(args.input, model_type=args.model_type,
                                is_blender=args.is_blender,
                                is_6dof=args.is_6dof)
    save_checkpoint(args.output, payload)
    n = sum(v.size for p in payload["vars"]["params"].values()
            for v in p.values())
    print(f"{args.input} -> {args.output} ({n} params)")


if __name__ == "__main__":
    main()
