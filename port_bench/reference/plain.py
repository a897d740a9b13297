"""The plain reference: one view of a deformable gaussian scene, in plain
PyTorch.

A frozen, independent statement of what the port computes, written
from the published method (3D Gaussian Splatting's EWA projection and
front-to-back alpha compositing, the deformable-3DGS MLP, Adam) with the
port's numerical conventions spelled out so that a sound port agrees to
rounding:

- the deformation MLP: frequency embedding in block order [x | sin | cos],
  8 x 256 ReLU layers with the input concatenated after layer 4, float32
  heads; ``hidden_dtype`` casts each hidden layer's input, kernel and
  bias (bfloat16 in training, as the recipe runs it);
- projection: world -> view, the 1.3 x tan(fov) clamp, the +0.3 low-pass,
  conic, 3-sigma radius, the exact 1/255 support extent, SH up to degree 3;
- binning: 16 x 16 tiles, each gaussian's covered tile rectangle, clamped
  to a budget of K tiles around its mean (the renderer's pair budget),
  pairs ordered by tile, then by depth quantized over the emitting
  gaussians' range (19 bits), then by pair id;
- compositing: alpha = exp(min(log op - q/2, log 0.99)), pairs below 1/255
  skipped, a pixel stops before the pair that would take its
  transmittance under 1e-4; [acc, values] per pixel, computed here by a
  cumulative sum over each tile's pairs (not a sequential walk), in
  chunks of tiles, differentiable by autograd.

Nothing here imports the port, jax or the JAX package. ``dtype`` runs the
projection, compositing and loss in a lower precision: the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
PIX = TILE * TILE
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOG_ALPHA_MAX = float(np.log(ALPHA_MAX))
LOG_ALPHA_EPS = float(np.log(ALPHA_EPS))
LOG_T_EPS = float(np.log(T_EPS))
DEPTH_BITS = 19

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def plain_precision():
    """float32 means float32 on the card: no TF32 in matmuls or convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- deform


def frequency_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xs = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)


def deform_mlp(weights: list, xyz: torch.Tensor, t: torch.Tensor,
               depth: int, multires: int, t_multires: int,
               hidden_dtype=None):
    """(d_xyz, d_rotation, d_scaling). `weights`: [W_0, b_0, ..., W_{D-1},
    b_{D-1}, W_xyz, b_xyz, W_rot, b_rot, W_scale, b_scale], each W (out,
    in). The skip concatenates the embedded input after layer depth // 2."""
    inp = torch.cat([frequency_embed(xyz, multires),
                     frequency_embed(t, t_multires)], dim=-1)
    h = inp
    for i in range(depth):
        w, b = weights[2 * i], weights[2 * i + 1]
        if hidden_dtype is None:
            h = torch.relu(F.linear(h, w, b))
        else:
            h = torch.relu(F.linear(h.to(hidden_dtype), w.to(hidden_dtype),
                                    b.to(hidden_dtype)))
        if i == depth // 2:
            h = torch.cat([inp.to(h.dtype), h], dim=-1)
    h = h.float()
    heads = [F.linear(h, weights[2 * depth + 2 * k],
                      weights[2 * depth + 2 * k + 1]) for k in range(3)]
    return heads[0], heads[1], heads[2]


# ------------------------------------------------------------ projection


def cov3d_of(scales: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """Packed [xx, xy, xz, yy, yz, zz] of R diag(s^2) R^T, R of the
    normalized wxyz quaternion."""
    q = rots / torch.linalg.norm(rots, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    s = [scales[:, k] ** 2 for k in range(3)]

    def entry(i, j):
        return s[0] * r[i][0] * r[j][0] + s[1] * r[i][1] * r[j][1] \
            + s[2] * r[i][2] * r[j][2]

    return torch.stack([entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1),
                        entry(1, 2), entry(2, 2)], dim=1)


def sh_basis(deg: int, x, y, z) -> list:
    out = [torch.full_like(x, SH_C0)]
    if deg > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if deg > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return out


def world_view_matrix(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Row-vector world -> view matrix of a camera with cam-to-world
    rotation R (stored transposed, COLMAP style) and translation T,
    through the camera-to-world matrix as the method builds it."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    return np.float32(np.linalg.inv(c2w)).T


def full_projection(wv: np.ndarray, fovx: float, fovy: float,
                    znear: float = 0.01, zfar: float = 100.0) -> np.ndarray:
    """World -> clip (row-vector), 3DGS z convention."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right + right)
    P[1, 1] = 2.0 * znear / (top + top)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return wv @ P.T


class View:
    """One camera: world-view and full projection (row-vector, float32
    tensors), its centre, tan of the half fields of view, the image size."""

    def __init__(self, wv: np.ndarray, fovx: float, fovy: float, height: int,
                 width: int, device, znear: float = 0.01, zfar: float = 100.0):
        full = full_projection(wv, fovx, fovy, znear, zfar)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.wv = t(wv)
        self.full = t(full)
        self.campos = t(np.linalg.inv(wv)[3, :3])
        self.tanfovx = t(np.tan(fovx / 2))
        self.tanfovy = t(np.tan(fovy / 2))
        self.height, self.width = height, width


def project(view: View, xyz, scales, rots, opacity, sh, sh_degree: int,
            dtype=torch.float32, znear: float = 0.2):
    """EWA projection -> dict of mean2d (N,2), conic (N,3), depth (N,),
    radius (N,), extent (N,2), color (N,3), opacity (N,), valid (N,)."""
    c = lambda x: x.to(dtype)  # noqa: E731
    xyz, scales, rots, opacity, sh = map(c, (xyz, scales, rots, opacity, sh))
    WV, FP = c(view.wv), c(view.full)
    H, W = view.height, view.width
    mx, my, mz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    tx = mx * WV[0, 0] + my * WV[1, 0] + mz * WV[2, 0] + WV[3, 0]
    ty = mx * WV[0, 1] + my * WV[1, 1] + mz * WV[2, 1] + WV[3, 1]
    tz_raw = mx * WV[0, 2] + my * WV[1, 2] + mz * WV[2, 2] + WV[3, 2]
    behind = tz_raw <= znear
    tz = torch.where(behind, torch.ones_like(tz_raw), tz_raw)
    hx = mx * FP[0, 0] + my * FP[1, 0] + mz * FP[2, 0] + FP[3, 0]
    hy = mx * FP[0, 1] + my * FP[1, 1] + mz * FP[2, 1] + FP[3, 1]
    hw = mx * FP[0, 3] + my * FP[1, 3] + mz * FP[2, 3] + FP[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    px = ((hx * p_w + 1.0) * W - 1.0) * 0.5
    py = ((hy * p_w + 1.0) * H - 1.0) * 0.5

    tanx, tany = c(view.tanfovx), c(view.tanfovy)
    txtz = torch.clamp(tx / tz, -1.3 * tanx, 1.3 * tanx) * tz
    tytz = torch.clamp(ty / tz, -1.3 * tany, 1.3 * tany) * tz
    focal_x = torch.div(torch.full_like(tanx, float(W)), 2.0 * tanx)
    focal_y = torch.div(torch.full_like(tany, float(H)), 2.0 * tany)
    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -(focal_x * txtz) * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -(focal_y * tytz) * inv_tz * inv_tz
    t00 = j00 * WV[0, 0] + j02 * WV[0, 2]
    t01 = j00 * WV[1, 0] + j02 * WV[1, 2]
    t02 = j00 * WV[2, 0] + j02 * WV[2, 2]
    t10 = j11 * WV[0, 1] + j12 * WV[0, 2]
    t11 = j11 * WV[1, 1] + j12 * WV[1, 2]
    t12 = j11 * WV[2, 1] + j12 * WV[2, 2]
    cov = cov3d_of(scales, rots)
    cxx, cxy, cxz, cyy, cyz, czz = (cov[:, k] for k in range(6))
    s0t0 = cxx * t00 + cxy * t01 + cxz * t02
    s1t0 = cxy * t00 + cyy * t01 + cyz * t02
    s2t0 = cxz * t00 + cyz * t01 + czz * t02
    s0t1 = cxx * t10 + cxy * t11 + cxz * t12
    s1t1 = cxy * t10 + cyy * t11 + cyz * t12
    s2t1 = cxz * t10 + cyz * t11 + czz * t12
    a = t00 * s0t0 + t01 * s1t0 + t02 * s2t0 + 0.3
    b = t00 * s0t1 + t01 * s1t1 + t02 * s2t1
    cc = t10 * s0t1 + t11 * s1t1 + t12 * s2t1 + 0.3
    det = a * cc - b * b
    det_inv = 1.0 / (det + 1e-12)
    conic = torch.stack([cc * det_inv, -b * det_inv, a * det_inv], dim=1)
    mid = 0.5 * (a + cc)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    valid = ~behind & (det > 0.0) & (opacity > 0.0)
    valid = valid & (px + radius > 0) & (px - radius < W) \
        & (py + radius > 0) & (py - radius < H)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    t_sup = 2.0 * (torch.log(torch.clamp(opacity, min=1e-38))
                   - float(np.log(ALPHA_EPS)))
    t_sup = torch.clamp(t_sup, min=0.0)
    pad = float(1.0 + 4.0 * np.float32(np.finfo(np.float32).eps))
    ex = torch.minimum(torch.sqrt(t_sup * torch.clamp(a, min=0.0)) * pad,
                       radius)
    ey = torch.minimum(torch.sqrt(t_sup * torch.clamp(cc, min=0.0)) * pad,
                       radius)
    extent = torch.where(valid[:, None], torch.stack([ex, ey], dim=1),
                         torch.zeros_like(xyz[:, :2]))
    campos = c(view.campos)
    dx, dy, dz = mx - campos[0], my - campos[1], mz - campos[2]
    inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-18)
    bas = sh_basis(sh_degree, dx * inv_n, dy * inv_n, dz * inv_n)
    k = min(len(bas), sh.shape[1])
    color = torch.stack([sum(bas[i] * sh[:, i, ch] for i in range(k))
                         for ch in range(3)], dim=1)
    color = torch.clamp(color + 0.5, min=0.0)
    return {"mean2d": torch.stack([px, py], dim=1), "conic": conic,
            "depth": tz, "radius": radius, "extent": extent, "color": color,
            "opacity": opacity, "valid": valid}


def deformed_gaussians(params: dict, alive, d_xyz, d_rot, d_scale):
    """Activated, deformed (xyz, scales, rotations, opacity, sh):
    deltas added to the activated values, rotation renormalised, opacity
    of dead slots zero."""
    xyz = params["xyz"] + d_xyz
    scales = torch.exp(params["scaling"]) + d_scale
    rot = params["rotation"] / (torch.linalg.norm(
        params["rotation"], dim=-1, keepdim=True) + 1e-12)
    rot = rot + d_rot
    rot = rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-12)
    opacity = torch.where(alive, torch.sigmoid(params["opacity"])[:, 0],
                          torch.zeros((), device=alive.device))
    sh = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return xyz, scales, rot, opacity, sh


# --------------------------------------------------------------- binning


class Bins:
    """Pairs of (tile, gaussian) in compositing order."""

    def __init__(self, gauss, tile_start, th, tw, dropped):
        self.gauss = gauss  # (P,) int64 gaussian of each pair, in order
        self.tile_start = tile_start  # (T + 1,) int64
        self.th, self.tw = th, tw
        self.dropped = dropped  # pairs the K budget dropped


def bin_pairs(proj: dict, height: int, width: int, K: int) -> Bins:
    """Each gaussian's covered tile rectangle (over its exact-support
    extent), clamped to at most K tiles centred on its mean, ordered by
    (tile, 19-bit depth over the emitting gaussians' range, pair id)."""
    th, tw = -(-height // TILE), -(-width // TILE)
    T = th * tw
    bits = DEPTH_BITS
    while (T + 1) > (1 << (32 - bits)):
        bits -= 1
    mean = proj["mean2d"].float()
    ext = proj["extent"].float()
    x, y = mean[:, 0], mean[:, 1]
    rx, ry = ext[:, 0], ext[:, 1]
    i32 = torch.int32
    tx0 = torch.clamp(torch.floor((x - rx) / TILE), 0, tw).to(i32)
    ty0 = torch.clamp(torch.floor((y - ry) / TILE), 0, th).to(i32)
    tx1 = torch.clamp(torch.floor((x + rx) / TILE) + 1, 0, tw).to(i32)
    ty1 = torch.clamp(torch.floor((y + ry) / TILE) + 1, 0, th).to(i32)
    rw = torch.clamp(tx1 - tx0, min=0)
    rh = torch.clamp(ty1 - ty0, min=0)
    covered = proj["valid"] & (proj["radius"] > 0) & (rx > 0) & (ry > 0)
    count = torch.where(covered, rw * rh, torch.zeros_like(rw))

    # the budget: a sub-rect of at most K tiles, aspect balanced, centred
    one, zero = torch.ones_like(rw), torch.zeros_like(rw)
    w2 = torch.round(torch.sqrt(K * torch.maximum(rw, one).float()
                                / torch.maximum(rh, one).float())).to(i32)
    w2 = torch.maximum(torch.minimum(torch.maximum(w2, one),
                                     torch.clamp(rw, max=K)), one)
    h2 = torch.div(torch.full_like(w2, K), w2, rounding_mode="floor")
    h2 = torch.minimum(torch.maximum(h2, one), torch.maximum(rh, one))
    count2 = torch.where(count > 0, w2 * h2, zero)
    cx = torch.floor(x / TILE).to(i32)
    cy = torch.floor(y / TILE).to(i32)
    cx = torch.minimum(torch.maximum(cx, tx0), tx0 + torch.maximum(rw - 1, zero))
    cy = torch.minimum(torch.maximum(cy, ty0), ty0 + torch.maximum(rh - 1, zero))
    x0 = torch.minimum(torch.maximum(cx - torch.div(w2, 2, rounding_mode="floor"),
                                     tx0), tx0 + torch.maximum(rw - w2, zero))
    y0 = torch.minimum(torch.maximum(cy - torch.div(h2, 2, rounding_mode="floor"),
                                     ty0), ty0 + torch.maximum(rh - h2, zero))
    dropped = int(torch.clamp(count - count2, min=0).sum())

    ks = torch.arange(K, dtype=i32, device=x.device)[None, :]
    tile = (y0[:, None] + torch.div(ks, w2[:, None], rounding_mode="floor")) \
        * tw + x0[:, None] + ks % w2[:, None]
    pvalid = ks < count2[:, None]
    emit = count2 > 0
    depth = proj["depth"].float()
    inf = torch.full_like(depth, float("inf"))
    dmin = torch.where(emit, depth, inf).min()
    dmax = torch.where(emit, depth, -inf).max()
    dq_max = float((1 << bits) - 1)
    scale = torch.div(torch.full_like(dmin, dq_max),
                      torch.clamp(dmax - dmin, min=1e-9))
    dq = torch.clamp((depth - dmin) * scale, 0.0, dq_max).to(torch.int64)
    key = (tile.to(torch.int64) << bits) | dq[:, None]
    key = torch.where(pvalid, key, torch.full_like(key, T << bits))
    skey, spid = torch.sort(key.reshape(-1), stable=True)
    n_valid = int(pvalid.sum())
    tile_start = torch.searchsorted(
        skey[:n_valid] >> bits,
        torch.arange(T + 1, dtype=torch.int64, device=x.device), side="left")
    return Bins(torch.div(spid[:n_valid], K, rounding_mode="floor"),
                tile_start, th, tw, dropped)


# ----------------------------------------------------------- compositing


def _chunks(lens: torch.Tensor, budget: int):
    """Groups of tile indices (longest first) whose padded pair-pixel
    count stays within `budget`."""
    order = torch.argsort(lens, descending=True).cpu()
    lens_h = lens.cpu()
    out, i = [], 0
    n = order.numel()
    while i < n:
        L = max(int(lens_h[order[i]]), 1)
        m = max(1, min(n - i, budget // (L * PIX)))
        out.append(order[i:i + m])
        i += m
    return out


def _composite_tiles(tiles, bins: Bins, mean2d, conic, logop, vals,
                     counts: dict | None):
    """[acc, values] (n_t, 256, 1 + V) of the given tiles."""
    dev = mean2d.device
    dtype = mean2d.dtype
    st = bins.tile_start[tiles]
    ln = bins.tile_start[tiles + 1] - st
    L = max(int(ln.max()), 1)
    ar = torch.arange(L, device=dev)
    valid = ar[None, :] < ln[:, None]  # (n_t, L)
    idx = torch.clamp(st[:, None] + ar[None, :], max=max(bins.gauss.numel() - 1, 0))
    g = bins.gauss[idx] if bins.gauss.numel() else torch.zeros_like(idx)
    ox = ((tiles % bins.tw) * TILE).to(dtype)[:, None, None]
    oy = (torch.div(tiles, bins.tw, rounding_mode="floor") * TILE).to(dtype)[:, None, None]
    pix = torch.arange(PIX, device=dev)
    fx = (pix % TILE).to(dtype)[None, None, :]
    fy = torch.div(pix, TILE, rounding_mode="floor").to(dtype)[None, None, :]
    m = mean2d[g]
    dx = (m[..., 0:1] - ox) - fx
    dy = (m[..., 1:2] - oy) - fy
    cg = conic[g]
    raw = -0.5 * (cg[..., 0:1] * dx * dx + cg[..., 2:3] * dy * dy) \
        - cg[..., 1:2] * dx * dy + logop[g][..., None]
    alog = torch.clamp(raw, max=LOG_ALPHA_MAX)
    ok = valid[..., None] & (alog >= LOG_ALPHA_EPS)
    zero = torch.zeros((), dtype=dtype, device=dev)
    alpha = torch.where(ok, torch.exp(alog), zero)
    l1m = torch.log1p(-alpha)
    cum = torch.cumsum(l1m, dim=1)
    live = ok & (cum >= LOG_T_EPS)
    logt_before = cum - l1m
    w = torch.where(live, torch.exp(alog + logt_before), zero)
    acc = w.sum(dim=1)
    v = torch.einsum("tlp,tlv->tpv", w, vals[g])
    if counts is not None:
        with torch.no_grad():
            stopped = ok & ~live
            first_stop = torch.where(stopped.any(dim=1),
                                     stopped.float().argmax(dim=1) + 1,
                                     ln[:, None].expand(-1, PIX))
            counts["evaluated"] += int(first_stop.sum())
            counts["contributing"] += int(live.sum())
            # the pairs a tile needs: up to its pixels' last stop
            counts["pairs"] += int(first_stop.max(dim=1).values.sum())
    return torch.cat([acc[..., None], v], dim=-1)


def composite(bins: Bins, mean2d, conic, logop, vals, height: int,
              width: int, counts: dict | None = None,
              budget: int = 1 << 25, grad_out=None):
    """The (H, W, 1 + V) [acc, values] image. With `grad_out` (H, W,
    1 + V), instead accumulates into the inputs' .grad the vector-Jacobian
    product of each chunk (recomputed under autograd, one chunk at a time,
    so memory stays bounded) and returns None."""
    T = bins.th * bins.tw
    dev = mean2d.device
    V = vals.shape[1]
    lens = bins.tile_start[1:] - bins.tile_start[:-1]
    if grad_out is not None:
        g_tiles = F.pad(grad_out, (0, 0, 0, bins.tw * TILE - width, 0,
                                   bins.th * TILE - height))
        g_tiles = g_tiles.reshape(bins.th, TILE, bins.tw, TILE, 1 + V) \
            .permute(0, 2, 1, 3, 4).reshape(T, PIX, 1 + V)
        inputs = [t for t in (mean2d, conic, logop, vals) if t.requires_grad]
        for tiles in _chunks(lens, budget):
            tiles = tiles.to(dev)
            if int(lens[tiles].max()) == 0:
                continue
            with torch.enable_grad():
                out = _composite_tiles(tiles, bins, mean2d, conic, logop,
                                       vals, None)
                grads = torch.autograd.grad(out, inputs, g_tiles[tiles],
                                            allow_unused=True)
            for t, gr in zip(inputs, grads):
                if gr is not None:
                    t.grad = gr if t.grad is None else t.grad + gr
        return None
    out = torch.zeros((T, PIX, 1 + V), dtype=mean2d.dtype, device=dev)
    with torch.no_grad():
        for tiles in _chunks(lens, budget):
            tiles = tiles.to(dev)
            if int(lens[tiles].max()) == 0:
                continue
            out[tiles] = _composite_tiles(tiles, bins, mean2d, conic, logop,
                                          vals, counts)
    img = out.reshape(bins.th, bins.tw, TILE, TILE, 1 + V).permute(0, 2, 1, 3, 4)
    return img.reshape(bins.th * TILE, bins.tw * TILE, 1 + V)[:height, :width]


def payload_of(proj: dict):
    """(mean2d, conic, log opacity, values [rgb, depth]) with invalid
    gaussians' rows zeroed and their log opacity log(1e-38)."""
    valid = proj["valid"]
    zero = torch.zeros((), dtype=proj["mean2d"].dtype, device=valid.device)
    op = torch.where(valid, proj["opacity"], zero)
    logop = torch.log(torch.clamp(op, min=1e-38))
    mean2d = torch.where(valid[:, None], proj["mean2d"], zero)
    conic = torch.where(valid[:, None], proj["conic"], zero)
    vals = torch.where(valid[:, None], torch.cat(
        [proj["color"], proj["depth"][:, None]], dim=1), zero)
    return mean2d, conic, logop, vals


# ------------------------------------------------------------------ loss


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images: 11 x 11 gaussian window of sigma
    1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    g = torch.tensor([math.exp(-((x - 5) ** 2) / (2 * 1.5 ** 2))
                      for x in range(11)], dtype=torch.float64)
    g = (g / g.sum()).to(torch.float32)
    win = torch.outer(g, g).to(device=img1.device, dtype=img1.dtype)
    c = img1.shape[0]
    w = win.expand(c, 1, 11, 11)

    def conv(x):
        return F.conv2d(x[None], w, padding=5, groups=c)[0]

    mu1, mu2 = conv(img1), conv(img2)
    s11 = conv(img1 * img1) - mu1 * mu1
    s22 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


# ------------------------------------------------------------- optimizer


def adam(param, grad, mu, nu, step: int, lr: float, row_mask=None,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step (torch.optim.Adam's rule, eps 1e-15 as 3DGS sets it);
    rows outside `row_mask` keep their parameters and moments."""
    if row_mask is not None:
        m = row_mask.reshape((-1,) + (1,) * (grad.ndim - 1))
        grad = torch.where(m, grad, torch.zeros((), device=grad.device))
    mu2 = b1 * mu + (1 - b1) * grad
    nu2 = b2 * nu + (1 - b2) * grad * grad
    upd = lr * (mu2 / (1 - b1 ** step)) / (
        torch.sqrt(nu2 / (1 - b2 ** step)) + eps)
    if row_mask is None:
        return param - upd, mu2, nu2
    return (torch.where(m, param - upd, param), torch.where(m, mu2, mu),
            torch.where(m, nu2, nu))


def expon_lr(step: int, lr_init: float, lr_final: float, delay_mult: float,
             max_steps: int, delay_steps: int = 0) -> float:
    """3DGS's log-linear learning-rate decay."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / delay_steps, 0, 1))
    else:
        delay = 1.0
    t = np.clip(step / max_steps, 0, 1)
    return float(delay * np.exp(np.log(lr_init) * (1 - t)
                                + np.log(lr_final) * t))
