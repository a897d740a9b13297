"""The projection kernels (trase_tpu_torch/csrc/project.cu through
ops/project_cuda.py) against their plain version (ops/projection.py:
compute_cov3d + project_gaussians, autograd for the gradients) on the card:
mean2d, depth, conic, radius, valid and extent bit for bit, the colour
within 1e-6 of its scale, every input's gradient within 1e-6 of its leaf's
scale, one launch each way, and one GAUSSIAN step against the same step on
the plain path. On the CPU, the renderer's projection takes the plain path
and launches nothing. Imports no jax, so it runs on the machine with the
card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_project_kernel.py

Without a CUDA device the card cases skip."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from trase_tpu_torch.models import gaussians as G
from trase_tpu_torch.ops import cuda_lib as CL
from trase_tpu_torch.ops import project_cuda as PC
from trase_tpu_torch.renderer import (apply_deformation, make_render_camera,
                                      project_view)

torch.set_num_threads(2)

H, W = 96, 128
FWD, BWD = ("project_fwd",), ("project_bwd",)
# the plain version's outputs that the forward equals bit for bit
EXACT = ("mean2d", "depth", "conic", "radius", "valid", "extent")
# colour against the plain version's (its coefficients summed in another
# order), each gradient against autograd's, as a share of the scale
COLOR_TOL = GRAD_TOL = 1e-6
# one GAUSSIAN step against the plain path's: the colour's rounding reaches
# the loss, the Adam moments and the densification statistics through the
# compositor and SSIM (a share of each tensor's scale)
STEP_TOL = 1e-5

# (sh_degree, stored rest coefficients, colour, scaling_modifier)
CASES = {
    "sh0": (0, 15, "sh", 1.0),
    "sh1": (1, 15, "sh", 1.0),
    "sh2": (2, 15, "sh", 1.0),
    "sh3": (3, 15, "sh", 1.0),
    "sh3_k9_stored": (3, 8, "sh", 1.0),
    "sh2_k2_stored": (2, 1, "sh", 1.0),
    "no_color": (3, 15, "none", 1.0),
    "override_color": (3, 15, "override", 1.0),
    "scaling_modifier": (3, 15, "sh", 1.37),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def camera(device):
    rot, _ = np.linalg.qr(np.array([[0.9, 0.1, 0.0], [-0.1, 0.9, 0.2],
                                    [0.0, -0.2, 0.95]]))
    return make_render_camera(rot, np.array([0.1, -0.2, 0.3]), 1.0, 0.8, H,
                              W, device=device)


def scene(n, n_rest, device, seed=0):
    """Rows of every kind: behind and just past znear (0.2), outside the
    image, zero opacity, needles (one long axis), scales so large that det
    overflows (not > 0), and ordinary ones."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    k = n // 10
    means[:k, 2] = rng.uniform(-1.0, 0.3, size=k)  # behind / near znear
    means[k:2 * k, 0] += 30.0  # outside the image
    scales = rng.uniform(0.01, 0.4, size=(n, 3)).astype(np.float32)
    scales[2 * k:3 * k, 0] = 2.0  # needles
    scales[3 * k:3 * k + 8] = 1e19  # det = inf - inf
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    opac = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    opac[::7] = 0.0
    dc = (0.5 * rng.normal(size=(n, 1, 3))).astype(np.float32)
    rest = (0.2 * rng.normal(size=(n, n_rest, 3))).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    return [torch.tensor(x, device=device)
            for x in (means, scales, rots, opac, dc, rest, colors)]


def project_both(case, device, grad, n=6000, seed=0):
    """The kernels' projection and the plain version's of one scene, with
    fresh leaves for each when `grad`; also the leaves and the kernel
    path's launches."""
    deg, n_rest, color, sm = CASES[case]
    cam = camera(device)
    base = scene(n, n_rest, device, seed)
    runs = []
    for fn in (PC.project, PC.project_plain):
        leaves = [x.clone().requires_grad_(grad) for x in base]
        means, scales, rots, opac, dc, rest, colors = leaves
        off = torch.zeros((n, 2), device=device, requires_grad=grad)
        if color == "none":
            colors = torch.zeros((n, 3), device=device)
        before = dict(CL.LAYOUT_LAUNCHES)
        with torch.set_grad_enabled(grad):
            proj = fn(means, scales, rots, opac, cam.buffers, H, W,
                      scaling_modifier=sm, sh_degree=deg, features_dc=dc,
                      features_rest=rest,
                      colors_precomp=None if color == "sh" else colors,
                      mean2d_offset=off)
        launched = {k: CL.LAYOUT_LAUNCHES.get(k, 0) - before.get(k, 0)
                    for k in (FWD, BWD)}
        runs.append((proj, [means, scales, rots, dc, rest, off, colors],
                     launched))
    return runs


def bits(t):
    """Bit patterns, every NaN alike."""
    t = t.detach()
    if t.dtype == torch.bool:
        return t
    return torch.where(torch.isnan(t), torch.full_like(t, float("nan")),
                       t).view(torch.int32)


def rel_gap(got, ref):
    """max |got - ref| over the finite entries / ref's largest finite
    magnitude; the NaN and inf positions must agree."""
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(got[~fin].isnan(), ref[~fin].isnan())
    if not fin.any():
        return 0.0
    scale = float(ref[fin].abs().max())
    gap = float((got[fin] - ref[fin]).abs().max())
    return gap / scale if scale else gap


def params_of(means, scales, rots, opac, dc, rest):
    """GaussianParams whose activations give these rows (scales capped at
    10: the renders do not want the overflowing rows)."""
    n, dev = means.shape[0], means.device
    return G.GaussianParams(
        xyz=means, features_dc=dc, features_rest=rest,
        scaling=torch.log(scales.clamp(max=10.0)), rotation=rots,
        opacity=torch.log(opac / (1 - opac + 1e-6) + 1e-6)[:, None],
        gaussian_features=torch.zeros((n, 32), device=dev),
        cluster_id=torch.zeros((n, 1), device=dev))


def test_cpu_projects_through_the_plain_path():
    """Off the card project_view is project_plain, bit for bit, and
    launches nothing."""
    deg, n_rest = 3, 15
    means, scales, rots, opac, dc, rest, _ = scene(200, n_rest, "cpu")
    params = params_of(means, scales, rots, opac, dc, rest)
    alive = torch.ones(200, dtype=torch.bool)
    cam = camera("cpu")
    off = torch.zeros((200, 2), requires_grad=True)
    before = dict(CL.LAYOUT_LAUNCHES)
    got = project_view(cam, params, alive, sh_degree=deg, mean2d_offset=off)
    got.mean2d.sum().backward()
    assert dict(CL.LAYOUT_LAUNCHES) == before
    ref = PC.project_plain(
        *apply_deformation(params, 0.0, 0.0, 0.0),
        G.get_opacity(params)[:, 0], cam.buffers, H, W, sh_degree=deg,
        features_dc=dc, features_rest=rest,
        mean2d_offset=torch.zeros((200, 2)))
    for name in EXACT + ("color", "opacity"):
        assert torch.equal(bits(getattr(got, name)),
                           bits(getattr(ref, name))), name
    assert torch.equal(off.grad, torch.ones_like(off))


def test_args_mirror_the_c_struct():
    """ops/project_cuda.py's ProjectArgs has csrc/project.cu's fields, in
    its order and of its types."""
    path = os.path.join(os.path.dirname(CL.SOURCES["project"]),
                        "project.cu")
    src = open(path).read()
    body = re.search(r"struct ProjectArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\**)\s*(\w+);", body, re.M)
    kinds = {"int32_t": ctypes.c_int32, "float": ctypes.c_float}
    want = [(name, ctypes.c_void_p if "*" in ctype else kinds[ctype])
            for ctype, name in fields]
    assert [(n, t) for n, t in PC.ProjectArgs._fields_] == want


@pytest.mark.parametrize("deg,stored,used", [(0, 16, 1), (1, 16, 4),
                                             (2, 16, 9), (3, 16, 16),
                                             (3, 9, 9), (2, 2, 2),
                                             (4, 25, 16)])
def test_n_basis(deg, stored, used):
    """The coefficients a render uses: sh_basis's count (it stops at
    degree 3), or the stored ones where fewer."""
    assert PC.n_basis(deg, stored) == used


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_plain(card, case):
    """Outside autograd: one forward launch, no backward; the geometry bit
    for bit, the colour within COLOR_TOL of its scale (or the given
    colours themselves)."""
    (kern, leaves, launched), (plain, _, _) = project_both(case, card,
                                                           grad=False)
    assert launched == {FWD: 1, BWD: 0}
    for name in EXACT:
        assert torch.equal(bits(getattr(kern, name)),
                           bits(getattr(plain, name))), name
    assert torch.equal(kern.opacity, plain.opacity)
    if CASES[case][2] == "sh":
        assert rel_gap(kern.color, plain.color) <= COLOR_TOL
    else:
        assert kern.color is plain.color or torch.equal(kern.color,
                                                        plain.color)
    assert bool(kern.valid.any()) and not bool(kern.valid.all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_autograd(card, case):
    """One forward and one backward launch; every leaf's gradient within
    GRAD_TOL of its scale of autograd's through the plain version, the
    screen offset's equal to the mean2d cotangent."""
    with_sh = CASES[case][2] == "sh"
    runs = project_both(case, card, grad=True)
    gen = torch.Generator(device=card).manual_seed(1)
    cots = None
    grads = []
    for proj, leaves, launched in runs:
        outs = [proj.mean2d, proj.depth, proj.conic]
        if with_sh:
            outs.append(proj.color)
        if cots is None:
            cots = [torch.randn(o.shape, generator=gen, device=card)
                    for o in outs]
        before = CL.LAYOUT_LAUNCHES.get(BWD, 0)
        wrt = leaves[:3] + (leaves[3:5] if with_sh else []) + [leaves[5]]
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        grads.append(torch.autograd.grad(loss, wrt))
        launched[BWD] += CL.LAYOUT_LAUNCHES.get(BWD, 0) - before
    assert runs[0][2] == {FWD: 1, BWD: 1}
    assert runs[1][2] == {FWD: 0, BWD: 0}
    names = ["means3d", "scales", "rots"] + (
        ["features_dc", "features_rest"] if with_sh else []) + ["offset"]
    for name, got, ref in zip(names, *grads):
        assert rel_gap(got, ref) <= GRAD_TOL, name
    assert torch.equal(grads[0][-1], cots[0])


@pytest.mark.cuda
def test_render_offset_gradient(card):
    """Through render (binning and the compositor), the densification
    signal that reaches mean2d_offset on the kernel path against the plain
    path's, with one launch each way."""
    from trase_tpu_torch.ops.rasterize import RasterConfig
    from trase_tpu_torch.renderer import render

    params = G.GaussianParams(*(  # trained as in a GAUSSIAN step
        t.requires_grad_(k in G.GaussianParams._fields[:6]) for k, t in zip(
            G.GaussianParams._fields,
            params_of(*scene(4000, 15, card)[:6]))))
    alive = torch.ones(4000, dtype=torch.bool, device=card)
    cam = camera(card)
    gen = torch.Generator(device=card).manual_seed(3)
    cot = torch.randn((3, H, W), generator=gen, device=card)
    got = []
    for fn in (PC.project, PC.project_plain):
        orig = PC.project
        PC.project = fn
        try:
            off = torch.zeros((4000, 2), device=card, requires_grad=True)
            before = dict(CL.LAYOUT_LAUNCHES)
            out = render(cam, params, alive, torch.zeros(3, device=card),
                         sh_degree=3, mean2d_offset=off, with_features=False,
                         raster_cfg=RasterConfig(pairs_per_gaussian=16))
            (out["render"] * cot).sum().backward()
            launched = {k: CL.LAYOUT_LAUNCHES.get(k, 0) - before.get(k, 0)
                        for k in (FWD, BWD)}
        finally:
            PC.project = orig
        got.append((off.grad, launched))
    assert got[0][1] == {FWD: 1, BWD: 1} and got[1][1] == {FWD: 0, BWD: 0}
    assert float(got[1][0].abs().max()) > 0
    assert rel_gap(got[0][0], got[1][0]) <= STEP_TOL


@pytest.mark.cuda
def test_gaussian_step_matches_plain_step(card):
    """One GAUSSIAN step on the bench-like scene through the kernels
    against the same step with the projection on its plain path: loss,
    every trained leaf's Adam moments and new values, the densification
    statistics within STEP_TOL of each tensor's scale; one launch each
    way."""
    from trase_tpu_torch.config import OptimizationParams
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.models import deform as TD
    from trase_tpu_torch.ops.rasterize import RasterConfig

    n = 4000
    params = params_of(*scene(n, 15, card, seed=5)[:6])
    aux = G.empty_aux(n, device=card)._replace(
        alive=torch.ones(n, dtype=torch.bool, device=card))
    net = TD.make_deform_network(device=card)
    cam = camera(card)
    gt = torch.rand((3, H, W), generator=torch.Generator(
        device=card).manual_seed(4), device=card)
    lrs = TT.make_learning_rate_schedules(OptimizationParams())(3000)
    results = []
    for fn in (PC.project, PC.project_plain):
        orig = PC.project
        PC.project = fn
        try:
            state = TT.init_train_state(params, aux, TT.deform_tensors(net))
            before = dict(CL.LAYOUT_LAUNCHES)
            new, m = TT.gaussian_phase_step(
                state, cam, gt, 0.3, 0.0, lrs, torch.zeros(3, device=card),
                deform_net=net, sh_degree=3, use_deform=False,
                is_6dof=False, lambda_dssim=0.2, lambda_reg_deform=0.0,
                raster_cfg=RasterConfig(pairs_per_gaussian=16))
            launched = {k: CL.LAYOUT_LAUNCHES.get(k, 0) - before.get(k, 0)
                        for k in (FWD, BWD)}
        finally:
            PC.project = orig
        results.append((new, m, launched))
    (kn, km, kl), (pn, pm, pl) = results
    assert kl == {FWD: 1, BWD: 1} and pl == {FWD: 0, BWD: 0}
    assert bool(km["finite"]) and bool(pm["finite"])
    assert abs(float(km["loss"]) - float(pm["loss"])) <= (
        STEP_TOL * abs(float(pm["loss"])))
    for k in TT.TRAINED:
        ko, po = getattr(kn.opt, k), getattr(pn.opt, k)
        assert rel_gap(ko.mu, po.mu) <= STEP_TOL, f"mu {k}"
        assert rel_gap(ko.nu, po.nu) <= 2 * STEP_TOL, f"nu {k}"
        big = po.mu.abs() > 0.05 * po.mu.abs().max()
        assert rel_gap(getattr(kn.params, k)[big],
                       getattr(pn.params, k)[big]) <= STEP_TOL, k
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert rel_gap(getattr(kn.aux, k), getattr(pn.aux, k)) <= STEP_TOL, k


@pytest.mark.cuda
def test_no_synchronising_call(card):
    """The forward and the backward launch under
    torch.cuda.set_sync_debug_mode("error"): neither waits for the
    device."""
    base = scene(2000, 15, card)
    cam = camera(card)
    leaves = [x.clone().requires_grad_(True) for x in base[:6]]
    means, scales, rots, opac, dc, rest = leaves
    off = torch.zeros((2000, 2), device=card, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        proj = PC.project(means, scales, rots, opac, cam.buffers, H, W,
                          sh_degree=3, features_dc=dc, features_rest=rest,
                          mean2d_offset=off)
        loss = (proj.mean2d.sum() + proj.conic.sum() + proj.depth.sum()
                + proj.color.sum())
        torch.autograd.grad(loss, [means, scales, rots, dc, rest, off])
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_offset_alone_launches_no_backward(card):
    """Where only the screen offset trains (the FEATURE step's densification
    statistics), the backward launches nothing and hands the offset the
    mean2d cotangent."""
    means, scales, rots, opac, dc, rest, _ = scene(2000, 15, card)
    off = torch.zeros((2000, 2), device=card, requires_grad=True)
    before = {k: CL.LAYOUT_LAUNCHES.get(k, 0) for k in (FWD, BWD)}
    proj = PC.project(means, scales, rots, opac, camera(card).buffers, H, W,
                      colors_precomp=torch.zeros((2000, 3), device=card),
                      mean2d_offset=off)
    cot = torch.randn((2000, 2), device=card)
    (g,) = torch.autograd.grad((proj.mean2d * cot).sum(), [off])
    assert torch.equal(g, cot)
    assert {k: CL.LAYOUT_LAUNCHES.get(k, 0) - before[k]
            for k in (FWD, BWD)} == {FWD: 1, BWD: 0}
