"""Port parity for models/vgg.py: trase_tpu_torch's VGGFeatureExtractor
against trase_tpu's on the same images (numpy seeds), VGG16 and VGG19,
single and block layer names, conv (pre-ReLU) and relu outputs, the
input's gradient (max-pool ties and ReLU at 0 on a flat image), normalize,
detach, the seeded fallback, the .npz / .pth loaders and
load_numpy_weights. Tolerance: 1e-4 of each layer's largest magnitude
(the same float32 convolutions, summed in another order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.models import vgg as JV

from trase_tpu_torch.models import vgg as TV

torch.set_num_threads(2)

TOL = 1e-4
SIZE, BATCH = 64, 2
NAMES = ["conv1_1", "relu1_2", "conv2", "relu3", "conv4_1", "relu5_3"]
BLOCKS = {"vgg16": (JV.VGG16_BLOCKS, TV.VGG16_BLOCKS),
          "vgg19": (JV.VGG19_BLOCKS, TV.VGG19_BLOCKS)}


def close(a, b, tol=TOL, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    err = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
    assert err < tol, (name, err)


def images(seed=0, batch=BATCH, size=SIZE):
    """Seeded images in [0, 1] with a flat quarter (max-pool ties, ReLU
    at 0) beside noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(batch, 3, size, size)).astype(np.float32)
    x[:, :, : size // 2, : size // 2] = 0.5
    return x


def pair(arch, names, weights=None, seed=0, normalization=None):
    jb, tb = BLOCKS[arch]
    j = JV.VGGFeatureExtractor(names, jb, weights, seed=seed,
                               normalization=normalization)
    t = TV.VGGFeatureExtractor(names, tb, weights, seed=seed,
                               normalization=normalization, device="cpu")
    return j, t


@pytest.mark.parametrize("arch", ["vgg16", "vgg19"])
def test_features_match(arch):
    """Every requested layer, batch 2 and a single (3, H, W) image."""
    j, t = pair(arch, NAMES)
    x = images()
    jo = j(jnp.asarray(x))
    with torch.no_grad():
        to = t(torch.from_numpy(x))
        single = t(torch.from_numpy(x[1]))
    assert list(to) == NAMES
    for name in NAMES:
        close(jo[name], to[name].numpy(), name=name)
        close(np.asarray(jo[name])[1:], single[name].numpy(), name=name)


def flipped_pools(j, t, x, names):
    """(count, mask): the 2x2 max-pool windows in front of the deepest of
    `names` whose largest entry is another one in each package (two
    entries within float noise of each other: the activations differ by
    ~1e-6 of their scale), and the input pixels those windows see, where
    the input gradients may then differ."""
    deepest = max(int(n[4]) for n in names)
    pooled = [f"relu{b}_{len(t.blocks[b - 1])}" for b in range(1, deepest)]
    weights = {k: (np.asarray(w), np.asarray(b))
               for k, (w, b) in j.weights.items()}
    jp = JV.VGGFeatureExtractor(pooled, j.blocks, weights)(jnp.asarray(x))
    probe = TV.VGGFeatureExtractor(pooled, t.blocks, weights, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    acts = probe(xt)
    total, count = 0.0, 0
    rng = np.random.default_rng(0)

    def windows(v):
        n, c, h, w = v.shape
        return v.reshape(n, c, h // 2, 2, w // 2, 2).transpose(
            0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)

    for name in pooled:
        a = acts[name]
        wj, wt = windows(np.asarray(jp[name])), windows(a.detach().numpy())
        flip = (wj.argmax(-1) != wt.argmax(-1)) & (wt.max(-1) > 0)
        count += int(flip.sum())
        sel = np.broadcast_to(flip[:, :, :, None, :, None],
                              flip.shape[:3] + (2, flip.shape[3], 2))
        cot = rng.uniform(1, 2, size=a.shape) * sel.reshape(a.shape)
        total = total + (a * torch.from_numpy(cot.astype(np.float32))).sum()
    if not count:
        return 0, np.zeros(x.shape[-2:], bool)
    g, = torch.autograd.grad(total, xt)
    return count, (g.abs().amax(dim=(0, 1)) > 0).numpy()


@pytest.mark.parametrize("arch", ["vgg16", "vgg19"])
def test_input_gradient_matches(arch):
    """jax.grad of <features, cotangent> against autograd on a partly flat
    image (tied max-pool windows, ReLU inputs at 0 pick the same entries
    in both). A window whose two largest inputs differ by float noise
    alone may pick another entry in each package: those windows are
    counted (this seed meets one, in relu1_2), and the gradients agree
    everywhere outside their receptive fields."""
    names = ["conv4_1", "relu2_2"]
    j, t = pair(arch, names)
    x = images(1)
    rng = np.random.default_rng(2)
    cot = {n: rng.normal(size=np.asarray(v).shape).astype(np.float32)
           for n, v in j(jnp.asarray(x)).items()}

    def jf(img):
        out = j(img)
        return sum(jnp.sum(out[n] * cot[n]) for n in names)

    jg = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t(xt)
    tg, = torch.autograd.grad(
        sum((out[n] * torch.from_numpy(cot[n])).sum() for n in names), xt)
    flips, field = flipped_pools(j, t, x, names)
    assert flips <= 2 and field.mean() < 0.1, (flips, field.mean())
    keep = ~field[None, None] & np.ones_like(jg, bool)
    close(jg[keep], tg.numpy()[keep], name="grad")


def test_flat_image_pool_and_relu_ties():
    """A constant image: every pool window ties and many conv outputs sit
    at or below 0; the gradients still agree."""
    j, t = pair("vgg16", ["relu2_1"])
    x = np.full((1, 3, 16, 16), 0.3, np.float32)
    jg = jax.grad(lambda i: jnp.sum(j(i)["relu2_1"]))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tg, = torch.autograd.grad(t(xt)["relu2_1"].sum(), xt)
    close(jg, tg.numpy(), name="flat grad")


def test_normalize_and_detach():
    j, t = pair("vgg16", ["conv1_1"],
                normalization=(np.array([0.1, 0.2, 0.3], np.float32),
                               np.array([0.5, 0.6, 0.7], np.float32)))
    x = images(3)
    close(j.normalize(jnp.asarray(x)), t.normalize(torch.from_numpy(x)),
          1e-6, "nchw")
    close(j.normalize(jnp.asarray(x[0])),
          t.normalize(torch.from_numpy(x[0])), 1e-6, "chw")
    xt = torch.from_numpy(x).requires_grad_(True)
    assert not t(xt, detach=True)["conv1_1"].requires_grad
    assert t(xt)["conv1_1"].requires_grad


def test_weights_are_buffers_up_to_the_last_needed_layer():
    """No parameters (a backward computes the input's gradient alone);
    the layers after conv4_1 are neither held nor run."""
    t = TV.VGGFeatureExtractor(["conv4_1"], TV.VGG16_BLOCKS, device="cpu")
    assert list(t.parameters()) == []
    held = sorted(n for n, _ in t.named_buffers() if n.startswith("w"))
    assert held == sorted(f"w{b}_{c}" for b, blk in enumerate(
        TV.VGG16_BLOCKS[:3]) for c in range(len(blk))) + ["w3_0"]


def test_seeded_fallback_equals_trase_tpu():
    """The same He-init draws, bit for bit, for every layer (and for the
    prefix an extractor stops at)."""
    j = JV.VGGFeatureExtractor(["relu5_3"], JV.VGG16_BLOCKS, seed=4)
    full = TV.seeded_weights(TV.VGG16_BLOCKS, 4)
    part = TV.seeded_weights(TV.VGG16_BLOCKS, 4, upto=(2, 1))
    assert len(part) == 6
    for k, (w, b) in j.weights.items():
        np.testing.assert_array_equal(np.asarray(w), full[k][0])
        np.testing.assert_array_equal(np.asarray(b), full[k][1])
        if k in part:
            np.testing.assert_array_equal(part[k][0], full[k][0])


@pytest.mark.parametrize("name,msg", [
    ("conv6_1", "Invalid layer name: conv6_1"),
    ("conv3_4", "block 3 has only 3 convs"),
    ("pool1", "Invalid layer name: pool1"),
    ("relu1_0", "Invalid layer name: relu1_0"),
])
def test_invalid_names_raise_the_same_error(name, msg):
    with pytest.raises(ValueError, match=msg) as je:
        JV.VGGFeatureExtractor([name], JV.VGG16_BLOCKS)
    with pytest.raises(ValueError) as te:
        TV.VGGFeatureExtractor([name], TV.VGG16_BLOCKS, device="cpu")
    assert str(te.value) == str(je.value)


def _weights(seed):
    return {k: (np.asarray(w), np.asarray(b) + 0.01 * (seed + 1))
            for k, (w, b) in JV.VGGFeatureExtractor(
                ["conv1_1"], JV.VGG16_BLOCKS, seed=seed).weights.items()}


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_weight_files_load_in_both(fmt, tmp_path):
    """An .npz in trase_tpu's {bi}_{ci}.w/.b format and a torchvision
    state_dict (features.<idx>, conv + relu per layer, a pool per block)
    through each package's make_vgg16_extractor."""
    w = _weights(6)
    path = str(tmp_path / f"vgg.{fmt}")
    if fmt == "npz":
        np.savez(path, **{f"{bi}_{ci}.{p}": v for (bi, ci), wb in w.items()
                          for p, v in zip("wb", wb)})
    else:
        sd, idx = {}, 0
        for bi, block in enumerate(TV.VGG16_BLOCKS):
            for ci in range(len(block)):
                sd[f"features.{idx}.weight"] = torch.tensor(w[bi, ci][0])
                sd[f"features.{idx}.bias"] = torch.tensor(w[bi, ci][1])
                idx += 2
            idx += 1
        torch.save(sd, path)
    names = ["relu3_3", "conv5_2"]
    j = JV.make_vgg16_extractor(names, path)
    t = TV.make_vgg16_extractor(names, path, device="cpu")
    for k in j.weights:
        np.testing.assert_array_equal(np.asarray(j.weights[k][1]), w[k][1])
    x = images(5, batch=1)
    jo = j(jnp.asarray(x))
    with torch.no_grad():
        to = t(torch.from_numpy(x))
    for n in names:
        close(jo[n], to[n].numpy(), name=n)


def test_missing_file_warns_and_falls_back(capsys):
    t = TV.make_vgg16_extractor(["conv1_1"], "/nonexistent/vgg.pth",
                                device="cpu")
    out = capsys.readouterr().out
    assert "weights not found" in out and "seeded random VGG16" in out
    np.testing.assert_array_equal(
        t.w0_0.numpy(), TV.seeded_weights(TV.VGG16_BLOCKS, 0, (0, 0))[
            (0, 0)][0])
    TV.make_vgg19_extractor(["conv1_1"], device="cpu")
    assert "seeded random VGG19" in capsys.readouterr().out


def test_load_numpy_weights_carries_trase_tpu_weights():
    """trase_tpu's extractor weights (np.asarray of its dict) into a port
    extractor built from another seed: the same features."""
    j = JV.VGGFeatureExtractor(["relu4_1"], JV.VGG16_BLOCKS, seed=9)
    t = TV.VGGFeatureExtractor(["relu4_1"], TV.VGG16_BLOCKS, seed=1,
                               device="cpu")
    TV.load_numpy_weights(t, {k: (np.asarray(w), np.asarray(b))
                              for k, (w, b) in j.weights.items()})
    x = images(7, batch=1)
    with torch.no_grad():
        got = t(torch.from_numpy(x))["relu4_1"].numpy()
    close(j(jnp.asarray(x))["relu4_1"], got, name="relu4_1")
    with pytest.raises(ValueError, match="weight"):
        TV.load_numpy_weights(t, {(0, 0): (np.zeros((3, 3, 3, 3)),
                                           np.zeros(3))})
