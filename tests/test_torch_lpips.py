"""Port parity for losses/lpips.py: make_lpips against trase_tpu's on the
same images and weight files (a seeded VGG16 .npz in trase_tpu's format,
written here), with linear heads from an .npz, from an official-style
.pth (both key spellings) and uniform; None without VGG weights. Values
within 1e-5 (absolute; LPIPS is O(0.1) here)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.losses import lpips as JL

from trase_tpu_torch.losses import lpips as TL
from trase_tpu_torch.models import vgg as TV

torch.set_num_threads(2)

TOL = 1e-5
SIZE = 64


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """A seeded VGG16 in trase_tpu's .npz layout (nonzero biases), and
    linear heads as .npz and as .pth in both key spellings."""
    base = tmp_path_factory.mktemp("lpips")
    vgg = TV.seeded_weights(TV.VGG16_BLOCKS, 11)
    rng = np.random.default_rng(12)
    vgg_npz = str(base / "vgg16.npz")
    np.savez(vgg_npz, **{f"{bi}_{ci}.{p}": v for (bi, ci), (w, b)
                         in vgg.items()
                         for p, v in (("w", w), ("b", b + rng.normal(
                             0, 0.05, size=b.shape).astype(np.float32)))})
    lins = [rng.uniform(0, 0.2, size=c).astype(np.float32)
            for c in TL._LPIPS_CHANNELS]
    files = {"vgg": vgg_npz, "heads": lins}
    files["npz"] = str(base / "lin.npz")
    np.savez(files["npz"], **{f"lin{i}": w for i, w in enumerate(lins)})
    for spelling in ("lin{i}.model.1.weight", "lins.{i}.model.1.weight"):
        path = str(base / f"lin_{spelling[:4]}.pth")
        torch.save({spelling.format(i=i): torch.tensor(w)[None, :, None,
                                                          None]
                    for i, w in enumerate(lins)}, path)
        files[spelling[:4]] = path
    return files


def images(seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (3, SIZE, SIZE) if batch is None else (batch, 3, SIZE, SIZE)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("heads", ["npz", "lin{", "lins", "uniform"])
@pytest.mark.parametrize("batch", [None, 2], ids=["chw", "nchw"])
def test_lpips_matches(weight_files, heads, batch):
    lin = None if heads == "uniform" else weight_files[heads]
    jf = JL.make_lpips(weight_files["vgg"], lin)
    tf = TL.make_lpips(weight_files["vgg"], lin, device="cpu")
    a, b = images(3, batch)
    jv = float(jf(jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        tv = float(tf(torch.from_numpy(a), torch.from_numpy(b)))
    assert np.isfinite(tv) and tv > 0
    assert abs(jv - tv) <= TOL, (jv, tv)
    with torch.no_grad():
        same = float(tf(torch.from_numpy(a), torch.from_numpy(a)))
    assert same == 0.0


def test_lin_weight_loaders(weight_files, tmp_path, capsys):
    """Both spellings and the .npz give the same heads as trase_tpu's
    loader; an incomplete file gives None, and make_lpips then warns and
    uses uniform heads."""
    for key in ("npz", "lin{", "lins"):
        got, want = TL.load_lin_weights(weight_files[key]), \
            JL.load_lin_weights(weight_files[key])
        for g, w, ref in zip(got, want, weight_files["heads"]):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, ref)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, lin0=np.ones(64, np.float32))
    assert TL.load_lin_weights(bad) is None is JL.load_lin_weights(bad)
    assert TL.load_lin_weights(None) is None
    TL.make_lpips(weight_files["vgg"], bad, device="cpu")
    assert "uniform heads" in capsys.readouterr().out


def test_without_vgg_weights_none():
    assert TL.make_lpips(None) is None
    assert TL.make_lpips("/nonexistent/vgg16.pth", device="cpu") is None
    assert JL.make_lpips(None) is None
