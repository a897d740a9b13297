"""The CUDA kernels (trase_tpu_torch/csrc/composite_fwd.cu, composite_bwd.cu,
deform_mlp.cu, mask_unpack.cu, smooth_rows_bwd.cu) against their plain
versions on the card: every
forward instantiation bit for bit and every backward instantiation on
scenes built for their edges (long tiles, warps that stop far apart,
empty tiles, early stops, ragged image sides), the compositor's
gradients under autograd, the reduce at both widths, the fused deform
MLP, the viewer's frames, composition and web server, the style step
through the kernels against the same step through their plain versions,
LPIPS, the mask unpack against native.unpack_masks_padded, the training
loop's mask miss (bits uploaded and unpacked, no synchronising call) and
the feature smoothing's backward at the benchmark's map, on the card.
Imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import numpy as np
import pytest
import torch

from trase_tpu_torch.ops import cuda_lib as CL
from trase_tpu_torch.ops import projection as TP
from trase_tpu_torch.ops import rasterize as TR
from trase_tpu_torch.ops import rasterize_cuda as TRC

torch.set_num_threads(2)


def _scene(n, H, W, n_feat, device):
    from trase_tpu_torch.renderer import make_render_camera

    rng = np.random.default_rng(6)
    means = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    means[:, 2] += 5.0
    scales = rng.uniform(0.05, 0.3, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.99, size=n).astype(np.float32)

    def t(x):
        return torch.tensor(x, device=device)

    cam = make_render_camera(np.eye(3), np.zeros(3), 1.0, 0.8, H, W,
                             device=device)
    proj = TP.project_gaussians(t(means), TP.compute_cov3d(t(scales), t(quats)),
                                t(opac), cam.buffers, H, W,
                                colors_precomp=t(colors))
    feats = None
    if n_feat:
        f = rng.normal(size=(n, n_feat)).astype(np.float32)
        feats = t(f / np.linalg.norm(f, axis=1, keepdims=True))
    return proj, feats


def _inputs(n, H, W, K=16):
    proj, _ = _scene(n, H, W, 0, "cuda")
    ci = TRC.composite_inputs(proj, None, H, W,
                              TR.RasterConfig(pairs_per_gaussian=K))
    return ci


@pytest.mark.cuda
def test_cuda_backward_matches_plain():
    """composite_bwd + reduce_pair_grads against their plain versions on
    one cotangent: the per-pixel terms are the same expressions (built
    with -fmad=false); only the 256-pixel sums associate differently."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = 96, 128
    ci = _inputs(400, H, W)
    args = (ci.payload, ci.sorted_gauss, ci.tile_start, H, W, 4, 0)
    _, logt, stop = TRC.composite_fwd(*args, residuals=True)
    g = torch.randn((H, W, 5), generator=torch.Generator().manual_seed(0)
                    ).cuda()
    first = torch.empty_like(logt)
    keys = (("composite_bwd", 4, 0, True, False), ("reduce_pair_grads", 10))
    before = [CL.LAYOUT_LAUNCHES.get(k, 0) for k in keys]
    dpair = TRC.composite_bwd(*args, g, logt, stop, logt_first=first)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    torch.cuda.synchronize()
    assert [CL.LAYOUT_LAUNCHES[k] for k in keys] == [b + 1 for b in before]
    stats = {}
    ref_pair = TRC.composite_bwd_plain(*args, g, logt, stop, stats=stats)
    nv = int(ci.tile_start[-1])
    scale = ref_pair[:nv].abs().amax(dim=0) + 1e-6
    assert float(((dpair[:nv] - ref_pair[:nv]).abs() / scale).max()) < 1e-5
    ref_pay = TRC.reduce_pair_grads_plain(dpair, inv, ci.tile_start, n)
    assert torch.equal(dpay, ref_pay)  # same sums in the same order
    assert float((first - stats["logt_first"]).abs().max()) < 1e-5
    assert float(first.abs().max()) < 1e-3


@pytest.mark.cuda
def test_render_gradients_on_card():
    """rasterize_tiled under autograd on the card (forward with
    residuals, backward kernel, reduce kernel) gives the gradients of the
    same call on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grads = {}
    for dev in ("cuda", "cpu"):
        proj, _ = _scene(50, 32, 32, 0, "cpu")
        proj = proj._replace(**{k: v.to(dev) for k, v in
                                proj._asdict().items() if v is not None})
        leaves = {k: getattr(proj, k).clone().requires_grad_(True)
                  for k in ("mean2d", "conic", "opacity", "color", "depth")}
        out = TRC.rasterize_tiled(proj._replace(**leaves), None,
                                  torch.zeros(3, device=dev), 32, 32)
        w = torch.linspace(-1, 1, 32 * 32 * 3, device=dev).reshape(3, 32, 32)
        loss = (out["render"] * w).sum() + out["alpha"].sum() \
            + 0.1 * out["depth"].sum()
        grads[dev] = dict(zip(leaves, (x.cpu() for x in torch.autograd.grad(
            loss, list(leaves.values())))))
    for k, ref in grads["cpu"].items():
        scale = float(ref.abs().max()) + 1e-8
        assert float((grads["cuda"][k] - ref).abs().max()) / scale < 1e-5, k


def _feature_inputs(pack, H=96, W=128, n=400):
    proj, feats = _scene(n, H, W, 32, "cuda")
    ci = TRC.composite_inputs(proj, feats, H, W, TR.RasterConfig(
        pairs_per_gaussian=16, pack_features=pack), with_color=False)
    assert (ci.n_val, ci.n_packed) == (32, 16 if pack else 0)
    payload = ci.payload
    if ci.n_packed:
        payload = TRC.pack_feature_words(payload, 32, 16, with_color=False)
    return ci, (payload, ci.sorted_gauss, ci.tile_start, H, W, 32,
                ci.n_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [False, True])
def test_cuda_features_only_backward_matches_plain(pack):
    """The features-only backward, full and values-only, against the
    plain version (256-pixel sums in another order: 1e-5 of each column's
    scale); values-only gives exact zeros in the geometry columns and the
    full mode's value columns bit for bit; the reduce at 38 words equals
    its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ci, args = _feature_inputs(pack)
    _, logt, stop = TRC.composite_fwd(*args, with_color=False,
                                      residuals=True)
    H, W = args[3], args[4]
    g = torch.randn((H, W, 33), generator=torch.Generator().manual_seed(0)
                    ).cuda()
    nv = int(ci.tile_start[-1])
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    got = {}
    for vo in (False, True):
        dpair = TRC.composite_bwd(*args, g, logt, stop, with_color=False,
                                  values_only=vo)
        dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
        torch.cuda.synchronize()
        ref = TRC.composite_bwd_plain(*args, g, logt, stop,
                                      with_color=False, values_only=vo)
        scale = ref[:nv].abs().amax(dim=0) + 1e-6
        assert float(((dpair[:nv] - ref[:nv]).abs() / scale).max()) < 1e-5
        assert dpay.shape == (n, 38)
        assert torch.equal(dpay, TRC.reduce_pair_grads_plain(
            dpair, inv, ci.tile_start, n))
        got[vo] = dpair[:nv]
    assert not bool(got[True][:, :6].any())
    assert torch.equal(got[True][:, 6:], got[False][:, 6:])
    assert bool(got[False][:, :6].any())


def _edge_scene(device, n_feat=32):
    """Projected splats placed by hand at 48x64 (3x4 tiles) for the
    backward's edges: tile 0 holds 400 faint wide splats (walks of 360-395
    pairs: more than two 64-pair batches) behind 6 opaque ones that cover
    only its first pixel rows (its warp 0 stops at pair 4, the other warps
    past 350); tiles 5 and 6 hold 20 ordinary splats; the other 9 tiles are
    empty; 4 invalid gaussians emit no pair."""
    rng = np.random.default_rng(8)
    parts = []

    def add(n, mx, my, conic, op, radius, depth, valid=True):
        parts.append(dict(mean2d=np.stack([mx, my], 1),
                          conic=np.tile(conic, (n, 1)), opacity=op,
                          radius=np.full(n, radius), depth=depth,
                          valid=np.full(n, valid)))

    add(400, rng.uniform(6, 10, 400), rng.uniform(6, 10, 400),
        [0.004, 0.0, 0.004], rng.uniform(0.02, 0.04, 400), 5.0,
        rng.uniform(2.0, 5.0, 400))
    add(6, np.full(6, 8.0), np.full(6, 0.5), [0.001, 0.0, 1.0],
        np.full(6, 0.999), 7.0, 1.0 + 0.01 * np.arange(6))
    add(20, rng.uniform(20, 44, 20), rng.uniform(20, 28, 20),
        [0.08, 0.01, 0.08], rng.uniform(0.3, 0.9, 20), 4.0,
        rng.uniform(2.0, 5.0, 20))
    add(4, rng.uniform(0, 64, 4), rng.uniform(0, 48, 4), [0.05, 0.0, 0.05],
        np.full(4, 0.9), 4.0, np.full(4, 3.0), valid=False)
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    n = len(cat["depth"])

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    proj = TP.ProjectedGaussians(
        mean2d=t(cat["mean2d"]), depth=t(cat["depth"]),
        conic=t(cat["conic"]), radius=t(cat["radius"]),
        color=t(rng.uniform(size=(n, 3))), opacity=t(cat["opacity"]),
        valid=t(cat["valid"], torch.bool))
    f = rng.normal(size=(n, n_feat))
    return proj, t(f / np.linalg.norm(f, axis=1, keepdims=True))


def _saturated_scene(H, W, device):
    """tests/test_torch_rasterize.py::saturated_scene through the port's
    projection (the mirror of test_zombie_window_grads): large, nearly
    opaque splats stacked in depth; every central pixel stops early."""
    from trase_tpu_torch.renderer import make_render_camera

    rng = np.random.default_rng(3)
    n = 24
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.uniform(-0.3, 0.3, size=(n, 2))
    means[:, 2] = np.linspace(-1.0, 1.0, n)
    scales = np.full((n, 3), 1.2, np.float32)
    quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.9, 0.985, size=n).astype(np.float32)
    f = rng.normal(size=(n, 32)).astype(np.float32)
    fov = np.deg2rad(60.0)
    cam = make_render_camera(np.eye(3), np.array([0.0, 0.0, 5.0]), fov, fov,
                             H, W, device=device)

    def t(x):
        return torch.tensor(x, device=device)

    proj = TP.project_gaussians(t(means), TP.compute_cov3d(t(scales), t(quats)),
                                t(opac), cam.buffers, H, W,
                                colors_precomp=t(colors))
    return proj, t(f / np.linalg.norm(f, axis=1, keepdims=True))


def _bwd_scene(name):
    """(proj, feats, H, W, K) of a test scene, on the card; "ragged" has
    sides that are not multiples of 16."""
    if name == "edges":
        return (*_edge_scene("cuda"), 48, 64, 8)
    if name == "saturated":
        return (*_saturated_scene(32, 48, "cuda"), 32, 48, 64)
    if name == "ragged":
        return (*_scene(400, 90, 117, 32, "cuda"), 90, 117, 16)
    return (*_scene(400, 96, 128, 32, "cuda"), 96, 128, 16)


# (n_val, n_packed, with_color, residuals): every forward instantiation
FWD_LAYOUTS = [(4, 0, True, False), (4, 0, True, True), (36, 0, True, False),
               (36, 0, True, True), (36, 16, True, False),
               (36, 16, True, True), (32, 0, False, False),
               (32, 0, False, True), (32, 16, False, False),
               (32, 16, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", FWD_LAYOUTS,
                         ids=["-".join(map(str, x)) for x in FWD_LAYOUTS])
@pytest.mark.parametrize("scene", ["edges", "saturated", "random", "ragged"])
def test_forward_instantiations_match_plain(scene, layout):
    """Each forward instantiation against composite_plain, bit for bit
    (the same expressions in the same order, built with -fmad=false): the
    image and, with residuals, each pixel's log T and stop index, which
    the backward reads by index alone. Scenes: walks of 360-395 pairs that
    cross several batches, a warp that stops at pair 4, empty tiles and
    invalid pairs ("edges"), the saturated early-stop scene, a random one
    and a random one whose sides are not multiples of 16. One launch,
    counted; the residual instantiation's image equals the plain
    instantiation's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_val, n_packed, with_color, residuals = layout
    proj, feats, H, W, K = _bwd_scene(scene)
    ci = TRC.composite_inputs(proj, None if n_val == 4 else feats, H, W,
                              TR.RasterConfig(pairs_per_gaussian=K,
                                              pack_features=n_packed > 0),
                              with_color)
    assert (ci.n_val, ci.n_packed) == (n_val, n_packed)
    payload = ci.payload
    if n_packed:
        payload = TRC.pack_feature_words(payload, n_val, n_packed,
                                         with_color)
    args = (payload, ci.sorted_gauss, ci.tile_start, H, W, n_val, n_packed)
    key = ("composite_fwd", n_val, n_packed, with_color, residuals)
    before = CL.LAYOUT_LAUNCHES.get(key, 0)
    got = TRC.composite_fwd(*args, with_color=with_color,
                            residuals=residuals)
    torch.cuda.synchronize()
    assert CL.LAYOUT_LAUNCHES[key] == before + 1
    ref = TRC.composite_plain(*args, with_color=with_color,
                              residuals=residuals)
    if residuals:
        (got, logt, stop), (ref, ref_logt, ref_stop) = got, ref
        assert torch.equal(stop, ref_stop) and torch.equal(logt, ref_logt)
        plain = TRC.composite_fwd(*args, with_color=with_color)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
        lens = (ci.tile_start[1:] - ci.tile_start[:-1]).repeat_interleave(
            256)
        assert bool((stop <= lens).all())
    assert got.shape == (H, W, 1 + n_val)
    assert torch.equal(got, ref)
    if scene in ("random", "ragged"):
        assert float(got[..., 0].max()) > 0.5  # the scene covers the image
    if scene == "edges":
        lens = ci.tile_start[1:] - ci.tile_start[:-1]
        assert int(lens.max()) > 2 * 128 and int((lens == 0).sum()) == 9


# (n_val, n_packed, with_color, values_only): every backward instantiation
BWD_LAYOUTS = [(4, 0, True, False), (4, 0, True, True),
               (36, 0, True, False), (36, 0, True, True),
               (36, 16, True, False), (36, 16, True, True),
               (32, 0, False, False), (32, 0, False, True),
               (32, 16, False, False), (32, 16, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", BWD_LAYOUTS,
                         ids=["-".join(map(str, x)) for x in BWD_LAYOUTS])
@pytest.mark.parametrize("scene", ["edges", "saturated", "random"])
def test_backward_instantiations_match_plain(scene, layout):
    """Each backward instantiation against composite_bwd_plain on scenes
    with a tile longer than two 64-pair batches, warps of one tile that
    stop ~90x apart, empty tiles and invalid pairs ("edges"), the
    saturated early-stop scene, and a random one: within 1e-5 of each
    column's scale (256-pixel sums in another order, the feature words'
    products fused into their sums), zero rows from the tile's largest
    stop on; a second launch gives the same bits; values-only gives exact
    zero geometry and the full mode's value columns bit for bit; the
    reduce equals its plain version bit for bit, twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_val, n_packed, with_color, values_only = layout
    proj, feats, H, W, K = _bwd_scene(scene)
    ci = TRC.composite_inputs(proj, None if n_val == 4 else feats, H, W,
                              TR.RasterConfig(pairs_per_gaussian=K,
                                              pack_features=n_packed > 0),
                              with_color)
    assert (ci.n_val, ci.n_packed) == (n_val, n_packed)
    payload = ci.payload
    if n_packed:
        payload = TRC.pack_feature_words(payload, n_val, n_packed,
                                         with_color)
    args = (payload, ci.sorted_gauss, ci.tile_start, H, W, n_val, n_packed)
    _, logt, stop = TRC.composite_fwd(*args, with_color=with_color,
                                      residuals=True)
    g = torch.randn((H, W, 1 + n_val),
                    generator=torch.Generator().manual_seed(0)).cuda()
    mode = dict(with_color=with_color, values_only=values_only)
    first = torch.empty_like(logt)
    dpair = TRC.composite_bwd(*args, g, logt, stop, logt_first=first, **mode)
    again = TRC.composite_bwd(*args, g, logt, stop, **mode)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    dpay_again = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    torch.cuda.synchronize()
    stats = {}
    ref = TRC.composite_bwd_plain(*args, g, logt, stop, stats=stats, **mode)
    nv = int(ci.tile_start[-1])
    scale = ref[:nv].abs().amax(dim=0) + 1e-6
    assert float(((dpair[:nv] - ref[:nv]).abs() / scale).max()) < 1e-5
    assert torch.equal(again[:nv], dpair[:nv])
    assert float((first - stats["logt_first"]).abs().max()) < 1e-5
    assert dpay.shape == (n, 6 + n_val)
    assert torch.equal(dpay, TRC.reduce_pair_grads_plain(
        dpair, inv, ci.tile_start, n))
    assert torch.equal(dpay_again, dpay)
    walk = stop.reshape(-1, 256).amax(dim=1)
    for t, w in enumerate(walk.tolist()):  # no gradient from the stop on
        lo, hi = int(ci.tile_start[t]) + w, int(ci.tile_start[t + 1])
        assert not bool(dpair[lo:hi].any())
    if values_only:
        full = TRC.composite_bwd(*args, g, logt, stop, with_color=with_color)
        torch.cuda.synchronize()
        assert not bool(dpair[:nv, :6].any())
        assert torch.equal(dpair[:nv, 6:], full[:nv, 6:])
    if scene == "edges":
        warps = stop.reshape(-1, 8, 32).amax(dim=2)
        lens = ci.tile_start[1:] - ci.tile_start[:-1]
        assert int(walk[0]) > 128 and int(warps[0, 0]) < 8
        assert int(warps[0, 1:].min()) > 300
        assert int((lens == 0).sum()) == 9 and nv < ci.sorted_gauss.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("words", [10, 38, 42])
@pytest.mark.parametrize("k", [6, 16, 64])
def test_reduce_matches_plain_bitwise(words, k):
    """The reduce kernel on random rows through a random permutation,
    with a third of the positions invalid (at or past n_valid): bit for
    bit its plain version (the same sums in k order), at the layouts'
    widths and at K below, at and above the 32 positions a warp loads at
    once; a ragged last warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 1000 + 3
    gen = torch.Generator().manual_seed(k + words)
    dpair = torch.randn((n * k, words), generator=gen).cuda()
    inv = torch.randperm(n * k, generator=gen).to(torch.int32).cuda()
    tile_start = torch.tensor([0, (2 * n * k) // 3], dtype=torch.int32,
                              device="cuda")
    key = ("reduce_pair_grads", words)
    before = CL.LAYOUT_LAUNCHES.get(key, 0)
    got = TRC.reduce_pair_grads(dpair, inv, tile_start, n)
    torch.cuda.synchronize()
    assert CL.LAYOUT_LAUNCHES[key] == before + 1
    assert torch.equal(got, TRC.reduce_pair_grads_plain(dpair, inv,
                                                        tile_start, n))


def _mlp_inputs(n, model_type, seed=0):
    """A seeded network of `model_type` on the card and the embedding of
    n seeded points at t = 0.42."""
    from trase_tpu_torch.models.deform import (
        frequency_embed, init_deform, make_deform_network)

    net = init_deform(make_deform_network(model_type, device="cuda"),
                      torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)
    xyz = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32),
                       device="cuda")
    t = torch.full((n, 1), 0.42, device="cuda")
    emb = torch.cat([frequency_embed(xyz, net.multires),
                     frequency_embed(t, net.t_multires)], 1)
    return net, xyz, t, emb


@pytest.mark.cuda
@pytest.mark.parametrize("n,model_type", [
    (1, "DeformNetwork"), (63, "DeformNetwork"), (64, "DeformNetwork"),
    (127, "DeformNetwork"), (128, "DeformNetwork"), (129, "DeformNetwork"),
    (300, "DeformNetwork"), (4096 + 7, "DeformNetwork"),
    (131072, "DeformNetwork"),
    (300, "DeformStaticNetwork"), (4096 + 7, "DeformStaticNetwork"),
    (300, "DeformDynamicNetwork"), (4096 + 7, "DeformDynamicNetwork")])
def test_deform_mlp_matches_plain(n, model_type):
    """The fused deform MLP kernel against fused_deform_mlp_plain on the
    same embedding (one row, rows around one warpgroup's 64 and one
    tile's 128, ragged last tiles, the bench capacity; input widths 84,
    68 and 128): bf16 operands with float32 sums in another order, so an
    activation near a bf16 rounding boundary may round the other way:
    1e-2 of each head's scale. One launch, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.models.deform import deform_step
    from trase_tpu_torch.ops import mlp_cuda as TM

    net, xyz, t, emb = _mlp_inputs(n, model_type)
    key = ("deform_mlp",)
    before = CL.LAYOUT_LAUNCHES.get(key, 0)
    got = deform_step(net, xyz, t, fused=True)
    torch.cuda.synchronize()
    assert CL.LAYOUT_LAUNCHES[key] == before + 1
    ref = TM.fused_deform_mlp_plain(net, emb)
    for a, b in zip(ref, got):
        assert b.shape == a.shape and bool(torch.isfinite(b).all())
        err = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-6)
        assert err <= 1e-2, err


@pytest.mark.cuda
def test_deform_mlp_relaunch_bit_identical():
    """No float atomics and a fixed sum order: a relaunch on the same
    inputs gives the same bits, at a ragged size over many tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.ops import mlp_cuda as TM

    net, _, _, emb = _mlp_inputs(4096 * 3 + 77, "DeformNetwork")
    dw = TM.fused_weights(net)
    first = TM.deform_mlp_cuda(dw, emb)
    second = TM.deform_mlp_cuda(dw, emb)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("row", [0, 70, 299])
def test_deform_mlp_nan_stays_in_its_row(row):
    """A NaN in one row of emb makes every output of that row NaN (ReLU
    passes NaN through, as jnp.maximum and torch.relu do) and leaves
    every other row's outputs bit for bit as without it: rows of one
    tile and of one warpgroup do not mix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.ops import mlp_cuda as TM

    net, _, _, emb = _mlp_inputs(300, "DeformNetwork")
    dw = TM.fused_weights(net)
    clean = TM.deform_mlp_cuda(dw, emb)
    bad = emb.clone()
    bad[row, 5] = float("nan")
    got = TM.deform_mlp_cuda(dw, bad)
    torch.cuda.synchronize()
    others = torch.ones(300, dtype=torch.bool, device="cuda")
    others[row] = False
    for a, b in zip(got, clean):
        assert bool(torch.isnan(a[row]).all())
        assert torch.equal(a[others], b[others])


def _synthetic_views(path):
    """{name: (image uint8, masks bool)} of a synthetic dataset dir."""
    import json
    import os

    from PIL import Image

    from trase_tpu_torch.data.masks import decode_mask_file

    out = {}
    for split in ("train", "test"):
        with open(os.path.join(path, f"transforms_{split}.json")) as f:
            frames = json.load(f)["frames"]
        for frame in frames:
            name = os.path.basename(frame["file_path"])
            img = np.asarray(Image.open(os.path.join(
                path, "images", f"{name}.png")), np.int32)
            out[name] = (img, decode_mask_file(os.path.join(
                path, "images", "masks", f"{name}.npz")))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_times", [0, 3])
def test_fast_gt_matches_oracle_on_card(tmp_path, n_times):
    """data/synthetic.py's fast GT on the card (the compositor kernel, two
    launches a view) against its oracle GT on the card at 64x64: PNGs
    within one 8-bit level, masks differing on at most 0.5 % of pixels
    (tests/test_torch_synthetic.py's bounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset

    kw = dict(n_train=6, n_test=3, image_size=64, n_times=n_times,
              device="cuda")
    CL.LAYOUT_LAUNCHES.clear()
    write_synthetic_dataset(str(tmp_path / "fast"), fast_gt=True, **kw)
    fwd = sum(v for k, v in CL.LAYOUT_LAUNCHES.items()
              if k[0] == "composite_fwd")
    write_synthetic_dataset(str(tmp_path / "oracle"), **kw)
    fast, oracle = (_synthetic_views(str(tmp_path / n))
                    for n in ("fast", "oracle"))
    assert sorted(fast) == sorted(oracle) and fwd == 2 * len(fast)
    for name, (img, masks) in oracle.items():
        assert np.abs(fast[name][0] - img).max() <= 1, name
        assert masks.any() and (fast[name][1] != masks).mean() <= 0.005, name


@pytest.mark.cuda
def test_checkpoint_restores_card_generators(tmp_path):
    """A trainer on the card checkpoints after FEATURE steps; a second
    trainer's load_ckpt gives the same state bit for bit, and its
    feature_gen (a CUDA generator) and densify_gen continue the first
    one's streams: the next draws are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from trase_tpu_torch import train as t_train
    from trase_tpu_torch.config import ModelParams, OptimizationParams
    from trase_tpu_torch.data.scene import Scene
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.engine.loop import Trainer

    src = str(tmp_path / "data")
    write_synthetic_dataset(src, n_train=4, n_test=1, image_size=64,
                            device="cuda")

    def trainer(name):
        args = t_train.parse_args([
            "-s", src, "-m", str(tmp_path / name), "--is_blender",
            "--iterations", "12", "--warm_up", "3",
            "--warm_up_3d_features", "4", "--iterative_opt_interval", "3",
            "--densify_from_iter", "2", "--densification_interval", "4",
            "--densify_until_iter", "9", "--num_sampled_pixels", "512",
            "--num_sampled_masks", "3"])
        ds = ModelParams.extract(args)
        os.makedirs(ds.model_path, exist_ok=True)
        return Trainer(ds, OptimizationParams.extract(args), None,
                       Scene(ds, shuffle=False, device="cuda"),
                       device="cuda")

    seen = {}

    def at_10(t, iteration, metrics):
        if iteration == 10:
            seen["state"] = TT.train_state_to_numpy(t.state)
            seen["gens"] = (t.feature_gen.get_state(),
                            t.densify_gen.get_state())

    a = trainer("a")
    a.train(checkpoint_iterations={10}, progress=False, on_iteration=at_10)
    assert a.feature_calls > 0 and a.feature_gen.device.type == "cuda"
    b = trainer("b")
    assert b.load_ckpt(str(tmp_path / "a" / "chkpnt10.pkl")) == 10
    got = TT.train_state_to_numpy(b.state)
    for part in ("params", "aux"):
        for k, v in seen["state"][part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    assert torch.equal(b.feature_gen.get_state(), seen["gens"][0])
    assert torch.equal(b.densify_gen.get_state(), seen["gens"][1])
    a.feature_gen.set_state(seen["gens"][0])
    x = torch.rand(64, device="cuda", generator=a.feature_gen)
    y = torch.rand(64, device="cuda", generator=b.feature_gen)
    assert torch.equal(x, y)


def _viewer_field(device, n=1500, capacity=1531, seed=11, shift=(0.0, 0.0, 0.0)):
    """A gaussian field around the origin in a ragged capacity, SH 1, with
    features grouped in halves (so a click selects half of it)."""
    from trase_tpu_torch.models import gaussians as G

    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.5 + shift).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    params, aux = G.from_point_cloud(pts, cols, sh_degree=1,
                                     capacity=capacity,
                                     dist2=np.full(n, 0.002, np.float32),
                                     device=device)
    feats = torch.zeros_like(params.gaussian_features)
    dirs = torch.eye(32, device=device)[:2]
    feats[:n] = dirs[torch.as_tensor(pts[:, 0] > 0, device=device).long()]
    return params._replace(gaussian_features=feats), aux, n


class _Capture:
    """composite_fwd's inputs and output inside a with-block."""

    def __enter__(self):
        self.fn, self.calls = TRC.composite_fwd, []

        def record(*a, **kw):
            out = self.fn(*a, **kw)
            self.calls.append((a, kw, out))
            return out

        TRC.composite_fwd = record
        return self

    def __exit__(self, *exc):
        TRC.composite_fwd = self.fn

    def plain_err(self):
        a, kw, out = self.calls[-1]
        torch.cuda.synchronize()
        return float((out - TRC.composite_plain(*a, **kw)).abs().max())


def _viewers(H=120, W=160):
    from trase_tpu_torch.models.deform import init_deform, make_deform_network
    from trase_tpu_torch.viewer import HeadlessViewer

    out = []
    for dev in ("cuda", "cpu"):
        params, aux, n = _viewer_field(dev)
        net = init_deform(make_deform_network(device=dev),
                          torch.Generator().manual_seed(0))
        for lin in net.flax_order()[-3:]:  # small deformations
            lin.weight.data *= 0.05
        v = HeadlessViewer(params, aux, n, deform_net=net.eval(), W=W, H=H,
                           sh_degree=1, radius=3.0, device=dev)
        v.fid = 0.4
        v.set_clusters(np.asarray(params.gaussian_features[:n, 0].cpu() > 0,
                                  np.int64),
                       np.tile([[0.9, 0.2, 0.1]], (n, 1)).astype(np.float32))
        out.append(v)
    return out


@pytest.mark.cuda
def test_viewer_frames_on_card():
    """Each mode launches the compositor once a frame (4 values); the
    Render frame's kernel output equals composite_plain on its inputs bit
    for bit; the card's frames and click selection equal the CPU
    viewer's (frames within tests/test_torch_render.py's 2e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.viewer import MODES

    card, cpu = _viewers()
    cpu._pca_rgb = card._pca()  # PCA signs are free
    tol = {"Segmentation": 2e-4, "Rendered Features": 2e-4, "Depth": 2e-3}
    for mode in MODES:
        key = ("composite_fwd", 4, 0, True, False)
        before = CL.LAYOUT_LAUNCHES.get(key, 0)
        img = card.render_frame(mode)
        assert CL.LAYOUT_LAUNCHES[key] == before + 1, mode
        assert img.shape == (3, 120, 160) and np.isfinite(img).all()
        if mode in tol:
            np.testing.assert_allclose(img, cpu.render_frame(mode),
                                       atol=tol[mode], rtol=0, err_msg=mode)
    with _Capture() as cap:
        out, _ = card._raw_frame()
    assert cap.plain_err() == 0.0
    ref, _ = cpu._raw_frame()
    np.testing.assert_allclose(out["render"].cpu().numpy(),
                               ref["render"].numpy(), atol=2e-4, rtol=0)
    alpha = ref["alpha"][0].numpy()
    py, px = np.unravel_index(int(np.argmax(alpha)), alpha.shape)
    assert card.click_select(px, py) == cpu.click_select(px, py) is not None
    assert torch.equal(card.segmented_mask.cpu(), cpu.segmented_mask)
    removed = card._raw_frame(mask=~card.segmented_mask)[0]["render"]
    np.testing.assert_allclose(
        removed.cpu().numpy(),
        cpu._raw_frame(mask=~cpu.segmented_mask)[0]["render"].numpy(),
        atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_render_composite_ragged_capacity_on_card():
    """A background of 1500 gaussians in 1531 slots plus an object of 77
    in 77 (a composite capacity of 1608), edited: one launch, the kernel's
    output equal to composite_plain's bit for bit, one projection launch,
    the image within 2e-4 of the CPU's render_composite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.ops import cuda_lib as CL
    from trase_tpu_torch.ops.rasterize import RasterConfig
    from trase_tpu_torch.renderer import make_render_camera, render_composite

    imgs = {}
    for dev in ("cuda", "cpu"):
        bg, bga, _ = _viewer_field(dev, shift=(0.0, 0.0, 4.0))
        obj, obja, _ = _viewer_field(dev, n=77, capacity=77, seed=12,
                                     shift=(0.3, 0.1, 3.5))
        rng = np.random.default_rng(2)
        d = [torch.tensor((0.05 * rng.normal(size=(77, k))).astype(
            np.float32), device=dev) for k in (3, 4, 3)]
        cam = make_render_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 90, 117,
                                 device=dev)
        projected = CL.LAYOUT_LAUNCHES.get(("project_fwd",), 0)
        with _Capture() as cap, torch.no_grad():
            imgs[dev] = render_composite(
                cam, bg, bga.alive, obj, obja.alive, *d,
                torch.tensor([0.1, 0.2, 0.3], device=dev), scales_bias=1.4,
                motion_bias=(0.3, -0.2, 0.4), rotation_bias=(0.4, -0.9, 1.3),
                sh_degree=1, raster_cfg=RasterConfig(pairs_per_gaussian=16)
            )["render"].cpu()
        if dev == "cuda":
            assert len(cap.calls) == 1 and cap.plain_err() == 0.0
            assert cap.calls[0][0][0].shape[0] == 1531 + 77
            assert CL.LAYOUT_LAUNCHES[("project_fwd",)] == projected + 1
    assert imgs["cuda"].shape == (3, 90, 117)
    np.testing.assert_allclose(imgs["cuda"].numpy(), imgs["cpu"].numpy(),
                               atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_web_frame_equals_render_frame_on_card():
    """The web server's /frame.jpg on the card decodes to the same pixels
    as a JPEG of render_frame at the same state (before and after an
    orbit and a click)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import io
    import json
    import urllib.request

    from PIL import Image

    from trase_tpu_torch.viewer_web import ViewerServer

    card, _ = _viewers()
    srv = ViewerServer(card)
    base = f"http://127.0.0.1:{srv.serve(port=0, block=False)}"

    def decoded(jpeg):
        with Image.open(io.BytesIO(jpeg)) as im:
            return np.asarray(im)

    def served():
        with urllib.request.urlopen(base + "/frame.jpg", timeout=60) as r:
            return decoded(r.read())

    def direct():
        with srv.lock:
            img = card.render_frame(apply_selection_removal=srv.removal)
        arr = (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        return decoded(buf.getvalue())

    try:
        np.testing.assert_array_equal(served(), direct())
        for body in ({"cmd": "orbit", "dx": 50, "dy": 20},
                     {"cmd": "click", "px": 80, "py": 60},
                     {"cmd": "removal", "on": True}):
            req = urllib.request.Request(
                base + "/cmd", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read())["ok"]
            np.testing.assert_array_equal(served(), direct())
    finally:
        srv.shutdown()


class _PlainKernels:
    """Inside the with-block the compositor's forward, backward and
    reduce run through their plain PyTorch versions, also on CUDA
    tensors."""

    NAMES = (("composite_fwd", "composite_plain"),
             ("composite_bwd", "composite_bwd_plain"),
             ("reduce_pair_grads", "reduce_pair_grads_plain"))

    def __enter__(self):
        self.saved = {k: getattr(TRC, k) for k, _ in self.NAMES}
        for k, plain in self.NAMES:
            setattr(TRC, k, getattr(TRC, plain))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(TRC, k, fn)


def _style_case(device):
    """A 2000-gaussian field (SH 1) seen at 96x128, half of it styled,
    against a seeded style image with a flat half; VGG16 conv4_1 with
    the seeded fallback."""
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.models.deform import (init_deform,
                                               make_deform_network)
    from trase_tpu_torch.models.vgg import VGG16_BLOCKS, VGGFeatureExtractor
    from trase_tpu_torch.renderer import make_render_camera

    params, aux, n = _viewer_field(device, n=2000, capacity=2048)
    params = params._replace(xyz=params.xyz + torch.tensor(
        [0.0, 0.0, 3.0], device=device))
    net = init_deform(make_deform_network(device=device),
                      torch.Generator().manual_seed(0))
    for lin in net.flax_order()[-3:]:
        lin.weight.data *= 0.05
    state = TT.init_train_state(params, aux, TT.deform_tensors(net))
    vgg = VGGFeatureExtractor(["conv4_1"], VGG16_BLOCKS, device=device)
    style = torch.rand((3, 96, 128), generator=torch.Generator()
                       .manual_seed(3)).to(device)
    style[:, :48] = 0.25
    with torch.no_grad():
        ref = vgg(vgg.normalize(style))["conv4_1"][0].reshape(512, -1)
    mask = params.xyz[:, 0] > 0
    cam = make_render_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 128,
                             device=device)
    lrs = TT.LearningRates(*([0.0025] * 8))

    def step(st):
        return TT.style_phase_step(
            st, cam, ref, mask, 0.4, lrs, torch.zeros(3, device=device),
            deform_net=net, vgg_ext=vgg, sh_degree=1, use_deform=True,
            is_6dof=False, fx_key="conv4_1",
            raster_cfg=TR.RasterConfig(pairs_per_gaussian=16))
    return state, step, mask & aux.alive


@pytest.mark.cuda
def test_style_step_kernels_match_plain_on_card():
    """One style step through the kernels (one launch each of the 4-value
    forward with residuals, its backward, the 10-word reduce, the update
    tail's two kernels over its 20 segments: 2 fields, densify, 17
    checked, and the projection's two: the colours are trained) against the same step with the compositor's three kernels
    through their plain versions on the card (both sides run the update
    tail's kernels, which tests/test_torch_update_tail.py holds to the
    plain tail): the loss bit for bit (the forward is), the colours' Adam
    moments within 1e-3 of their scale (the backward's 256-pixel sums
    associate differently), the colours where the gradient is clearly
    nonzero within 1e-3; rows outside the mask and every other field
    unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state, step, rows = _style_case("cuda")
    CL.LAYOUT_LAUNCHES.clear()
    new, m = step(state)
    torch.cuda.synchronize()
    assert CL.LAYOUT_LAUNCHES == {("composite_fwd", 4, 0, True, True): 1,
                                   ("composite_bwd", 4, 0, True, False): 1,
                                   ("reduce_pair_grads", 10): 1,
                                   ("update_tail", 20): 1,
                                   ("update_commit",): 1,
                                   ("project_fwd",): 1, ("project_bwd",): 1}
    with _PlainKernels():
        ref, rm = step(state)
    assert bool(m["finite"]) and float(m["loss"]) == float(rm["loss"])
    for k in ("features_dc", "features_rest"):
        a, b = getattr(new.opt, k), getattr(ref.opt, k)
        for part in ("mu", "nu"):
            x, y = getattr(a, part), getattr(b, part)
            err = float((x - y).abs().max() / y.abs().max())
            assert err < 1e-3, (k, part, err)
        big = b.mu.abs() > 0.05 * b.mu.abs().max()
        p, q = getattr(new.params, k), getattr(ref.params, k)
        assert float((p - q)[big].abs().max()
                     / q[big].abs().max()) < 1e-3, k
        old = getattr(state.params, k)
        assert torch.equal(p[~rows], old[~rows])
        assert not torch.equal(p[rows], old[rows])
    for name in ("xyz", "opacity", "scaling", "rotation",
                 "gaussian_features"):
        assert torch.equal(getattr(new.params, name),
                           getattr(state.params, name)), name
    assert torch.equal(new.aux.alive, state.aux.alive)
    for a, b in zip(new.deform, state.deform):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(tmp_path):
    """make_lpips on the card against --device cpu on the same seeded
    weight files and images: within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.losses.lpips import _LPIPS_CHANNELS, make_lpips
    from trase_tpu_torch.models.vgg import VGG16_BLOCKS, seeded_weights

    vgg = str(tmp_path / "vgg16.npz")
    np.savez(vgg, **{f"{bi}_{ci}.{p}": v for (bi, ci), (w, b)
                     in seeded_weights(VGG16_BLOCKS, 5).items()
                     for p, v in (("w", w), ("b", b))})
    rng = np.random.default_rng(8)
    lin = str(tmp_path / "lin.npz")
    np.savez(lin, **{f"lin{i}": rng.uniform(0, 0.2, c).astype(np.float32)
                     for i, c in enumerate(_LPIPS_CHANNELS)})
    a = rng.uniform(size=(3, 128, 160)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    vals = {}
    for dev in ("cuda", "cpu"):
        fn = make_lpips(vgg, lin, device=dev)
        with torch.no_grad():
            vals[dev] = float(fn(torch.from_numpy(a).to(dev),
                                 torch.from_numpy(b).to(dev)))
    assert np.isfinite(vals["cuda"]) and vals["cuda"] > 0
    assert abs(vals["cuda"] - vals["cpu"]) <= 1e-4, vals


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(4, 0, True), (32, 16, False)],
                         ids=["rgb_depth", "features_packed"])
@pytest.mark.parametrize("slabs", [2, 3])
def test_slab_mode_matches_plain_and_whole(layout, slabs):
    """The three kernels' slab mode on a ragged image (its 5 tile rows
    padded to a multiple of the slab count): each slab's forward, image
    and residuals, bit for bit against composite_plain's slab and,
    concatenated, against the whole image; each slab's backward rows bit
    for bit against the whole image's and within 1e-4 of each column
    group's scale of the plain version's; each slab's reduce bit for bit
    against its plain version on the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_val, n_packed, color = layout
    H, W = 72, 100
    th, tw = -(-H // 16), -(-W // 16)
    rows_local = -(-th // slabs)
    h_pad = rows_local * slabs * 16
    proj, feats = _scene(300, H, W, 0 if color else 32, "cuda")
    ci = TRC.composite_inputs(proj, feats, h_pad, W, TR.RasterConfig(
        pairs_per_gaussian=16, pack_features=bool(n_packed)), color)
    kpay = (TRC.pack_feature_words(ci.payload, n_val, n_packed, color)
            if n_packed else ci.payload)
    args = (kpay, ci.sorted_gauss, ci.tile_start, h_pad, W, n_val, n_packed)
    whole = TRC.composite_fwd(*args, residuals=True, with_color=color)
    g = torch.randn((h_pad, W, 1 + n_val), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2))
    wpair = TRC.composite_bwd(*args, g, whole[1], whole[2], with_color=color)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    parts = []
    for r in range(slabs):
        sl = dict(t_lo=r * rows_local * tw, t_hi=(r + 1) * rows_local * tw)
        out = TRC.composite_fwd(*args, residuals=True, with_color=color,
                                **sl)
        ref = TRC.composite_plain(*args, residuals=True, with_color=color,
                                  **sl)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        gr = g[r * rows_local * 16:(r + 1) * rows_local * 16].contiguous()
        dpair = TRC.composite_bwd(*args, gr, out[1], out[2],
                                  with_color=color, **sl)
        lo = int(ci.tile_start[sl["t_lo"]])
        hi = int(ci.tile_start[sl["t_hi"]])
        assert torch.equal(dpair[lo:hi], wpair[lo:hi])
        plain = TRC.composite_bwd_plain(*args, gr, out[1], out[2],
                                        with_color=color, **sl)
        for a, b in ((0, 2), (2, 5), (5, 6), (6, 6 + n_val)):
            scale = float(plain[lo:hi, a:b].abs().max()) + 1e-30
            assert float((dpair[lo:hi, a:b] - plain[lo:hi, a:b]).abs().max()
                         ) <= 1e-4 * scale
        dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n, **sl,
                                     sorted_gauss=ci.sorted_gauss)
        assert torch.equal(dpay, TRC.reduce_pair_grads_plain(
            dpair, inv, ci.tile_start, n, **sl))
        parts.append(out)
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])


@pytest.mark.cuda
def test_world_of_one_steps_equal_single_on_card(tmp_path):
    """A world of one over NCCL: the sharded GAUSSIAN step equals the
    single-device step bit for bit (the same operations: one rank's
    gathers copy, its slab is the whole image; without the deform
    regulariser, whose global mean the sharded step takes as a sum over
    the elements divided by their count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.deform import init_deform, make_deform_network
    from trase_tpu_torch.parallel import sharded as S
    from trase_tpu_torch.parallel.world import close_world, init_world
    from trase_tpu_torch.renderer import make_render_camera

    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(400, 3)) * 0.5).astype(np.float32)
    pts[:, 2] += 3.0
    params, aux = G.from_point_cloud(pts, rng.uniform(size=(400, 3)).astype(
        np.float32), sh_degree=1, capacity=512, device="cuda")
    net = init_deform(make_deform_network(device="cuda"),
                      torch.Generator().manual_seed(0))
    state = TT.init_train_state(params, aux, TT.deform_tensors(net))
    cam = make_render_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 72, 100,
                             device="cuda")
    gt = torch.rand((3, 72, 100), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    lrs = TT.LearningRates(*[1e-3] * 8)
    kw = dict(sh_degree=1, use_deform=True, is_6dof=False, lambda_dssim=0.2,
              lambda_reg_deform=0.0,
              raster_cfg=TR.RasterConfig(pairs_per_gaussian=16))
    single, sm = TT.gaussian_phase_step(state, cam, gt, 0.5, 0.0, lrs,
                                        torch.zeros(3, device="cuda"),
                                        deform_net=net, **kw)
    world = init_world(1, 0, "cuda", store_dir=str(tmp_path / "store"))
    try:
        step = S.make_sharded_gaussian_step(world, net, **kw)
        new, m = step(S.shard_train_state(state, world), cam, gt, 0.5, 0.0,
                      lrs, torch.zeros(3, device="cuda"))
    finally:
        close_world()
    assert float(m["loss"]) == float(sm["loss"])
    for a, b in zip(TT.float_tensors(new), TT.float_tensors(single)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,m_max", [(3, 5, 7, 6), (64, 1200, 1600, 64),
                                         (70, 8, 9, 64), (0, 5, 7, 4)])
def test_mask_unpack_matches_native(n, h, w, m_max):
    """The unpack kernel against the host unpacker, equal: bits that cross
    byte boundaries, the benchmark's stack, truncation past m_max, no
    masks; one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch import native
    from trase_tpu_torch.ops import mask_unpack as MU

    rng = np.random.default_rng(n + h)
    packed = rng.integers(0, 256, -(-n * h * w // 8), dtype=np.uint8)
    before = CL.LAYOUT_LAUNCHES.get(("mask_unpack",), 0)
    got = MU.unpack_masks(torch.from_numpy(packed).cuda(), n, h, w, m_max)
    assert CL.LAYOUT_LAUNCHES[("mask_unpack",)] == before + 1
    ref = torch.from_numpy(native.unpack_masks_padded(packed, n, h, w, m_max))
    assert got.shape == (m_max, h, w) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_mask_miss_on_card_is_bits_without_sync(tmp_path):
    """A CUDA trainer's mask misses, one taken from the prefetcher and one
    decoded inline, make no synchronising call (the sync debug mode
    raises on one), go up as bits (counted under mask_fetch's "bits") and
    cache the stack and validity of load_padded_masks, moved to the
    device; a hit returns the cached tuple itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from trase_tpu_torch import train as t_train
    from trase_tpu_torch.config import ModelParams, OptimizationParams
    from trase_tpu_torch.data import masks as DM
    from trase_tpu_torch.data.scene import Scene
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.engine import loop as TL

    src = str(tmp_path / "data")
    write_synthetic_dataset(src, n_train=4, n_test=1, image_size=64,
                            device="cuda")
    args = t_train.parse_args(["-s", src, "-m", str(tmp_path / "m"),
                               "--is_blender", "--load_mask_on_the_fly"])
    ds = ModelParams.extract(args)
    os.makedirs(ds.model_path, exist_ok=True)
    tr = TL.Trainer(ds, OptimizationParams.extract(args), None,
                    Scene(ds, shuffle=False, device="cuda"), device="cuda")
    cams = tr.scene.get_train_cameras()
    assert all(c.mask_path and c.masks is None for c in cams)
    assert DM.load_stack(cams[0].mask_path, 4).bits.is_pinned()
    tr._prepare_mask_meta(cams)
    before = dict(TL.MASK_FETCH)
    try:
        tr._masks_for(cams[3])  # builds the kernel and warms the allocators
        tr._submit_mask_prefetch(cams[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [tr._masks_for(cams[0]), tr._masks_for(cams[1])]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        tr._close_prefetcher()
    assert TL.MASK_FETCH[("bits", "miss")] == before.get(("bits", "miss"),
                                                         0) + 3
    assert TL.MASK_FETCH.get(("float32", "miss"), 0) == before.get(
        ("float32", "miss"), 0)
    for cam, (masks, valid) in zip(cams, got):
        ref = DM.load_padded_masks(cam.mask_path, tr._m_max)
        assert masks.device.type == valid.device.type == "cuda"
        assert torch.equal(masks.cpu(), torch.from_numpy(ref.masks))
        assert torch.equal(valid.cpu(), torch.from_numpy(ref.valid))
        assert tr._masks_for(cam) is got[cams.index(cam)]


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["all", "8-of-16"])
def test_smooth_rows_bwd_matches_plain_on_card(draw):
    """The smoothing's backward at the n3v benchmark's map (262144 rows x
    16 slots, 32 features, 62144 dead rows tied at the origin: hubs split
    into chunks) equal to its plain version on the card, bit-identical on
    a second call, one counted launch a call; through autograd as
    smooth_rows' gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trase_tpu_torch.ops import knn as TK

    n, dead, k, f = 262144, 62144, 16, 32
    g = torch.Generator(device="cuda").manual_seed(11)
    xyz = torch.zeros((n, 3), device="cuda")
    xyz[:n - dead] = 2.0 * torch.randn((n - dead, 3), generator=g,
                                       device="cuda") + 5.0
    smap = TK.transpose_smooth_map(TK.build_feature_smooth_map(xyz, k))
    assert smap.hub_rows.numel() > 0 and smap.max_in_degree >= dead
    slots = None if draw == "all" else torch.randperm(
        k, generator=g, device="cuda")[:k // 2]
    cot = torch.randn((n, f), generator=g, device="cuda")
    key = ("smooth_rows_bwd",)
    before = CL.LAYOUT_LAUNCHES.get(key, 0)
    got = TK.smooth_rows_bwd(cot, smap, slots)
    again = TK.smooth_rows_bwd(cot, smap, slots)
    assert CL.LAYOUT_LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, TK.smooth_rows_bwd_plain(cot, smap, slots))
    normed = torch.randn((n, f), generator=g,
                         device="cuda").requires_grad_(True)
    out = TK.smooth_rows(normed, smap, slots)
    grad, = torch.autograd.grad(out, normed, cot)
    assert CL.LAYOUT_LAUNCHES[key] == before + 3
    assert torch.equal(grad, got)
