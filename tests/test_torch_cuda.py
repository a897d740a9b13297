"""The CUDA kernels (trase_tpu_torch/csrc/composite_fwd.cu, composite_bwd.cu,
deform_mlp.cu) against their plain PyTorch versions on the card: every
forward instantiation bit for bit and every backward instantiation on
scenes built for their edges (long tiles, warps that stop far apart,
empty tiles, early stops, ragged image sides), the compositor's
gradients under autograd, the reduce at both widths, and the fused deform
MLP. Imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import numpy as np
import pytest
import torch

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
    before = [TRC.LAYOUT_LAUNCHES.get(k, 0) for k in keys]
    dpair = TRC.composite_bwd(*args, g, logt, stop, logt_first=first)
    inv = TRC.inverse_pairs(ci.sorted_pid)
    n = ci.payload.shape[0]
    dpay = TRC.reduce_pair_grads(dpair, inv, ci.tile_start, n)
    torch.cuda.synchronize()
    assert [TRC.LAYOUT_LAUNCHES[k] for k in keys] == [b + 1 for b in before]
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
               (36, 16, True, False), (32, 0, False, False),
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
    before = TRC.LAYOUT_LAUNCHES.get(key, 0)
    got = TRC.composite_fwd(*args, with_color=with_color,
                            residuals=residuals)
    torch.cuda.synchronize()
    assert TRC.LAYOUT_LAUNCHES[key] == before + 1
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
BWD_LAYOUTS = [(4, 0, True, False), (32, 0, False, False),
               (32, 0, False, True), (32, 16, False, False),
               (32, 16, False, True)]


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
    ci = TRC.composite_inputs(proj, None if with_color else feats, H, W,
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
@pytest.mark.parametrize("words", [10, 38])
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
    before = TRC.LAYOUT_LAUNCHES.get(key, 0)
    got = TRC.reduce_pair_grads(dpair, inv, tile_start, n)
    torch.cuda.synchronize()
    assert TRC.LAYOUT_LAUNCHES[key] == before + 1
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
    before = TRC.LAYOUT_LAUNCHES.get(key, 0)
    got = deform_step(net, xyz, t, fused=True)
    torch.cuda.synchronize()
    assert TRC.LAYOUT_LAUNCHES[key] == before + 1
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
