"""Scenes, cameras, ground truth and deformation weights from a seed.

Everything here is made on the device with ``torch.Generator``s seeded from
the run's seed and a fixed stream number, in a few large calls, so that a
seed always gives the same inputs and every seed gives the same sizes.
The distributions are parameters of the configuration file
(``scene``), each with its reason there. Nothing here imports the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# stream numbers: each input has its own generator
S_POSITIONS, S_SCALES, S_OPACITY, S_COLOUR, S_ROTATION, S_FEATURES, \
    S_DEFORM, S_GT, S_MISC = range(9)
DEAD_OPACITY_LOGIT = -15.0


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one input stream of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + stream) % (1 << 63))
    return g


def _normal(shape, g, device, mean=0.0, std=1.0):
    return torch.randn(shape, generator=g, device=device) * std + mean


def make_gaussians(scene: dict, capacity: int, n_alive: int, sh_degree: int,
                   feature_dim: int, seed: int, device) -> tuple[dict, torch.Tensor]:
    """(params, alive): raw parameters of a fixed-capacity field, the
    first `n_alive` slots alive, the rest parked as dead slots (opacity
    logit -15, log-scale -10, identity rotation)."""
    n = n_alive
    obj, bg = scene["objects"], scene["background"]
    n_bg = int(round(n * bg["share"]))
    n_obj = n - n_bg

    g = generator(seed, S_POSITIONS, device)
    lo = torch.tensor([b[0] for b in obj["center_box"]], device=device)
    hi = torch.tensor([b[1] for b in obj["center_box"]], device=device)
    centres = lo + (hi - lo) * torch.rand((obj["count"], 3), generator=g,
                                          device=device)
    which = torch.randint(0, obj["count"], (n_obj,), generator=g,
                          device=device)
    xyz_obj = centres[which] + _normal((n_obj, 3), g, device,
                                       std=obj["spread"])
    d = _normal((n_bg, 3), g, device)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True).clamp(min=1e-6)
    r = bg["radius"][0] + (bg["radius"][1] - bg["radius"][0]) * torch.rand(
        (n_bg, 1), generator=g, device=device)
    xyz = torch.cat([xyz_obj, d * r], dim=0)

    g = generator(seed, S_SCALES, device)
    ls = scene["log_scale"]
    base = torch.cat([
        _normal((n_obj, 1), g, device, math.log(ls["object_median"]),
                ls["std"]),
        _normal((n_bg, 1), g, device, math.log(ls["background_median"]),
                ls["std"])], dim=0)
    log_scale = base + _normal((n, 3), g, device, std=ls["axis_std"])
    large = scene["large"]
    n_large = int(round(n * large["share"]))
    large_idx = torch.randperm(n, generator=g, device=device)[:n_large]
    log_scale[large_idx] = _normal((n_large, 3), g, device,
                                   math.log(large["median"]), large["std"])

    g = generator(seed, S_OPACITY, device)
    op = scene["opacity_logit"]
    high = torch.rand((n,), generator=g, device=device) < op["high_share"]
    logit = torch.where(
        high, _normal((n,), g, device, op["high_mean"], op["high_std"]),
        _normal((n,), g, device, op["low_mean"], op["low_std"]))
    logit[large_idx] = _normal((n_large,), g, device, large["opacity_logit"],
                               op["low_std"])

    g = generator(seed, S_COLOUR, device)
    sh = scene["sh"]
    n_rest = (sh_degree + 1) ** 2 - 1
    dc = _normal((n, 1, 3), g, device, std=sh["dc_std"])
    band_std = torch.tensor(
        [sh["rest_std"][int(math.isqrt(k + 1)) - 1] for k in range(n_rest)],
        device=device)
    rest = _normal((n, n_rest, 3), g, device) * band_std[None, :, None]

    g = generator(seed, S_ROTATION, device)
    rot = _normal((n, 4), g, device)

    g = generator(seed, S_FEATURES, device)
    feats = _normal((n, feature_dim), g, device,
                    std=scene["features"]["std"])

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    params = {
        "xyz": full((capacity, 3), 0.0),
        "features_dc": full((capacity, 1, 3), 0.0),
        "features_rest": full((capacity, n_rest, 3), 0.0),
        "scaling": full((capacity, 3), -10.0),
        "rotation": torch.cat([full((capacity, 1), 1.0),
                               full((capacity, 3), 0.0)], dim=1),
        "opacity": full((capacity, 1), DEAD_OPACITY_LOGIT),
        "gaussian_features": full((capacity, feature_dim), 0.0),
        "cluster_id": full((capacity, 1), -1.0),
    }
    params["xyz"][:n] = xyz
    params["features_dc"][:n] = dc
    params["features_rest"][:n] = rest
    params["scaling"][:n] = log_scale
    params["rotation"][:n] = rot
    params["opacity"][:n, 0] = logit
    params["gaussian_features"][:n] = feats
    alive = torch.zeros(capacity, dtype=torch.bool, device=device)
    alive[:n] = True
    return params, alive


def deform_shapes(deform: dict) -> list:
    """(out, in) of each Linear of the deformation MLP in call order:
    D hidden layers (the input concatenated after layer D // 2), then the
    d_xyz, d_rotation and d_scaling heads."""
    in_ch = 3 * (1 + 2 * deform["multires"]) + (1 + 2 * deform["t_multires"])
    W, D = deform["W"], deform["D"]
    shapes = []
    for i in range(D):
        fan_in = in_ch if i == 0 else W
        if i == D // 2 + 1:
            fan_in += in_ch
        shapes.append((W, fan_in))
    return shapes + [(3, W), (4, W), (3, W)]


def make_deform_weights(deform: dict, seed: int, device) -> list:
    """[W_0, b_0, ...] in call order: LeCun-normal kernels (std
    1/sqrt(fan_in)), biases N(0, bias_std), the heads' kernels scaled by
    head_scale, as a trained field's small deltas are."""
    g = generator(seed, S_DEFORM, device)
    shapes = deform_shapes(deform)
    out = []
    for i, (o, k) in enumerate(shapes):
        scale = deform["head_scale"] if i >= deform["D"] else 1.0
        out.append(_normal((o, k), g, device, std=scale / math.sqrt(k)))
        out.append(_normal((o,), g, device, std=deform["bias_std"] * scale))
    return out


def _look_at_rows(centre: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World -> camera rotation (rows: right, down, forward; OpenCV)."""
    fwd = target - centre
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])


def make_views(cfg: dict, traffic: dict) -> list:
    """The training views: dicts of R (cam-to-world, stored transposed as
    COLMAP does), T (world -> camera translation), fovx, fovy, height,
    width, fid and name. The rig is the configuration's, the number of
    frames held the traffic's; the layout does not depend on the seed."""
    rig = cfg["rig"]
    W, H = cfg["image_width"], cfg["image_height"]
    focal = rig["focal_px_at_capture"] * W / cfg["capture"][0]
    fovx = 2 * math.atan(W / (2 * focal))
    fovy = 2 * math.atan(H / (2 * focal))
    cams, frames = traffic["cameras"], traffic["frames"]
    n_time = rig["frames"]
    views = []
    for f in range(frames):
        # frames spread evenly over the clip
        frame = (f * (n_time - 1)) // max(frames - 1, 1)
        for c in range(cams):
            k = len(views)
            u = c / max(cams - 1, 1) - 0.5 if cams > 1 else \
                (k / max(frames - 1, 1)) - 0.5
            az = math.radians(rig["azimuth_span_deg"] * u)
            el = math.radians(rig["elevation_deg"]
                              + rig["elevation_wobble_deg"]
                              * math.sin(2 * math.pi * (c if cams > 1 else k)
                                         / 7.0))
            r = rig["radius"]
            centre = np.array([r * math.sin(az) * math.cos(el),
                               -r * math.sin(el),
                               -r * math.cos(az) * math.cos(el)])
            rows = _look_at_rows(centre, np.zeros(3))
            views.append({"R": rows.T.copy(), "T": -rows @ centre,
                          "fovx": fovx, "fovy": fovy, "height": H,
                          "width": W, "fid": frame / max(n_time - 1, 1),
                          "name": f"cam{c:02d}_f{frame:04d}"})
    return views


def make_gt(n_views: int, height: int, width: int, seed: int, device,
            first: int = 0, count: int | None = None) -> torch.Tensor:
    """(count, 3, H, W) float32 ground-truth images in [0, 1]: a smooth
    colour field (bicubic from a 1/64 grid) plus finer detail (bilinear
    from a 1/8 grid, amplitude 0.15). View i is drawn from its own
    generator, so any subset regenerates alone."""
    count = n_views - first if count is None else count
    out = torch.empty((count, 3, height, width), device=device)
    coarse = (max(height // 64, 2), max(width // 64, 2))
    fine = (max(height // 8, 2), max(width // 8, 2))
    for j in range(count):
        g = generator(seed, S_GT, device)
        g.manual_seed((int(seed) * 16 + S_GT + 16 * (first + j + 1) * 7919)
                      % (1 << 63))
        c = torch.rand((1, 3) + coarse, generator=g, device=device)
        d = torch.randn((1, 3) + fine, generator=g, device=device)
        img = F.interpolate(c, (height, width), mode="bicubic",
                            align_corners=False) \
            + 0.15 * F.interpolate(d, (height, width), mode="bilinear",
                                   align_corners=False)
        out[j] = img[0].clamp(0.0, 1.0)
    return out


S_MASKS = 9


def make_masks(masks: dict, height: int, width: int, seed: int, view: int,
               device) -> torch.Tensor:
    """(M, H, W) bool SAM-style masks of one view, from the view's own
    generator: a few large regions bounded by random lines (walls, floor,
    background) and ellipses of log-uniform size (objects and their
    parts), overlapping as SAM's multi-granular masks do."""
    g = generator(seed, S_MASKS, device)
    g.manual_seed((int(seed) * 16 + S_MASKS + 16 * (view + 1) * 104729)
                  % (1 << 63))
    n, n_large = masks["per_view"], masks["large"]
    ys = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    out = torch.empty((n, height, width), dtype=torch.bool, device=device)
    u = torch.rand((n, 6), generator=g, device=device)
    for i in range(n):
        cx, cy = u[i, 0] * width, u[i, 1] * height
        if i < n_large:
            ang = u[i, 2] * 2 * math.pi
            out[i] = (xs - cx) * torch.cos(ang) + (ys - cy) * torch.sin(ang) > 0
            continue
        lo, hi = masks["radius_frac"]
        r = math.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                     * float(u[i, 3])) * width
        a, b = r, r * (0.4 + 0.6 * float(u[i, 4]))
        ang = u[i, 5] * math.pi
        dx, dy = xs - cx, ys - cy
        xr = dx * torch.cos(ang) + dy * torch.sin(ang)
        yr = -dx * torch.sin(ang) + dy * torch.cos(ang)
        out[i] = (xr / a) ** 2 + (yr / b) ** 2 <= 1.0
    return out


def pack_masks(m: torch.Tensor) -> np.ndarray:
    """The masks' bits packed most significant first, as np.packbits
    packs them, on the masks' device; the host gets an eighth of them."""
    flat = m.reshape(-1).to(torch.int32)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 8)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=m.device)
    return (flat.view(-1, 8) * weights).sum(1).to(torch.uint8).cpu().numpy()


def write_masks(path: str, packed: np.ndarray, shape: tuple):
    """The native mask file the port's loader reads, as extract_masks
    writes it (``data/masks.py: save_mask_file``): the packed bits with N,
    H, W, deflated."""
    n, h, w = shape
    np.savez_compressed(path, packed=packed, N=n, H=h, W=w)
