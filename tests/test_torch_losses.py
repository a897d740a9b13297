"""Port parity for the FEATURE step's helpers: the contrastive losses,
pixel weights and correspondence matrices (from one injected sample), the
bilinear resize, the KNN map and feature smoothing, and the SAM-mask
files and padding, against trase_tpu on the same numpy inputs."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.data import masks as JM
from trase_tpu.losses import contrastive as JC
from trase_tpu.ops import knn as JK
from trase_tpu.utils.image import bilinear_resize_mm as j_resize

from trase_tpu_torch.data import masks as TM
from trase_tpu_torch.losses import contrastive as TC
from trase_tpu_torch.ops import knn as TK
from trase_tpu_torch.utils.image import bilinear_resize_mm as t_resize

torch.set_num_threads(2)


def masks_and_sample(seed=0, m=6, h=12, w=16, p=40):
    """Random masks (the last one padding) and trase_tpu's sample of
    them, with the port's copy of the sample."""
    rng = np.random.default_rng(seed)
    masks = (rng.random((m, h, w)) > 0.55).astype(np.float32)
    masks[-1] = 0.0
    valid = np.arange(m) < m - 1
    s = JC.sample_pixels_and_masks(jax.random.PRNGKey(seed),
                                   jnp.asarray(masks), jnp.asarray(valid),
                                   p, 3)
    ts = TC.PixelSample(torch.from_numpy(np.array(s.pixel_idx)).long(),
                        torch.from_numpy(np.array(s.pixel_valid)),
                        torch.from_numpy(np.array(s.mask_sel)))
    return masks, valid, s, ts


def test_correspondence_and_weights_match():
    """The pixel-mask correspondence matrix is equal; the weights and the
    cosine gram within 1e-6 (float32 sums in another order)."""
    masks, _, s, ts = masks_and_sample()
    C = np.asarray(JC.pixel_mask_correspondence_matrix(jnp.asarray(masks),
                                                       s))
    got = TC.pixel_mask_correspondence_matrix(torch.from_numpy(masks), ts)
    np.testing.assert_array_equal(got.numpy(), C)
    assert 0 < C.sum() < C.size
    np.testing.assert_allclose(
        TC.pixel_weights(torch.from_numpy(masks), ts).numpy(),
        np.asarray(JC.pixel_weights(jnp.asarray(masks), s)), atol=1e-6,
        rtol=1e-6)
    f = np.random.default_rng(1).normal(size=(12, 16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        TC.cosine_gram(torch.from_numpy(f).reshape(-1, 8)[ts.pixel_idx])
        .numpy(),
        np.asarray(JC.features_correspondence_matrix_hwc(jnp.asarray(f),
                                                         s)), atol=1e-6)


@pytest.mark.parametrize("mode", ["hard", "all", "soft"])
def test_contrastive_losses_match(mode):
    """Each positive / negative pair loss, with and without pixel
    weights, and its gradient in the gram: 1e-6."""
    masks, _, s, ts = masks_and_sample(seed=2)
    rng = np.random.default_rng(3)
    f = rng.normal(size=(s.pixel_idx.shape[0], 8)).astype(np.float32)
    f[:, 0] += 1.0  # a spread of similarities across both thresholds
    jm, tm = jnp.asarray(masks), torch.from_numpy(masks)
    C = JC.pixel_mask_correspondence_matrix(jm, s)
    tC = TC.pixel_mask_correspondence_matrix(tm, ts)
    for weighted in (False, True):
        jw = JC.pixel_weights(jm, s) if weighted else None
        tw = TC.pixel_weights(tm, ts) if weighted else None
        for jfn, tfn in ((JC.positive_pixel_pair_loss[mode],
                          TC.positive_pixel_pair_loss[mode]),
                         (JC.negative_pixel_pair_loss[mode],
                          TC.negative_pixel_pair_loss[mode])):
            ref, rg = jax.value_and_grad(
                lambda x: jfn(C, JC._cosine_gram(x), s, weights=jw))(
                    jnp.asarray(f))
            x = torch.from_numpy(f).requires_grad_(True)
            got = tfn(tC, TC.cosine_gram(x), ts, weights=tw)
            g, = torch.autograd.grad(got, x)
            assert abs(float(ref) - float(got.detach())) < 1e-6, mode
            assert float(ref) != 0.0
            np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6)


def test_sample_pixels_and_masks_properties():
    """The port draws its own sample (a torch.Generator, not trase_tpu's
    key): exactly P distinct pixels, valid ones inside the masks' union
    and invalid ones only once the union is used up; selected masks are
    real ones; the same seed gives the same sample."""
    masks, valid, _, _ = masks_and_sample(seed=4, h=10, w=10)
    tm, tv = torch.from_numpy(masks), torch.from_numpy(valid)
    union = int((masks.sum(0) > 0).sum())
    for p in (30, 100):
        s = TC.sample_pixels_and_masks(torch.Generator().manual_seed(0), tm,
                                       tv, p, 3)
        idx = s.pixel_idx.numpy()
        assert len(set(idx.tolist())) == p
        inside = (masks.sum(0) > 0).reshape(-1)[idx]
        assert inside[s.pixel_valid.numpy()].all()
        assert int(s.pixel_valid.sum()) == min(p, union)
        assert not (s.mask_sel.numpy() & ~valid).any()
        again = TC.sample_pixels_and_masks(torch.Generator().manual_seed(0),
                                           tm, tv, p, 3)
        assert torch.equal(again.pixel_idx, s.pixel_idx)


def test_bilinear_resize_matches():
    """A 2x downscale of an (H, W, 33) image, and its gradient: 1e-6
    against trase_tpu, and equal to torch's interpolate (the reference's
    resample) within 1e-6."""
    rng = np.random.default_rng(5)
    img = rng.normal(size=(24, 40, 33)).astype(np.float32)
    w = rng.normal(size=(12, 20, 33)).astype(np.float32)
    ref, rg = jax.value_and_grad(
        lambda x: jnp.sum(j_resize(x, 12, 20) * w))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    out = t_resize(x, 12, 20)
    g, = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_resize(jnp.asarray(img), 12, 20)),
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6)
    interp = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(2, 0, 1)[None], size=(12, 20),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    np.testing.assert_allclose(out.detach().numpy(), interp.numpy(),
                               atol=1e-6)


def test_knn_and_smooth_map_match():
    """Distinct random points (no ties): KNN distances within 1e-5 and
    the smoothing map equal to trase_tpu's. With tied points (dead slots
    share their xyz) only the distances are compared: the two top-k may
    order tied neighbours differently."""
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    jd, ji = JK.knn(jnp.asarray(pts), jnp.asarray(pts), 16, chunk=128)
    td, ti = TK.knn(torch.from_numpy(pts), torch.from_numpy(pts), 16,
                    chunk=128)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(
        TK.build_feature_smooth_map(torch.from_numpy(pts), 16).numpy(),
        np.asarray(JK.build_feature_smooth_map(jnp.asarray(pts), 16)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tied = pts.copy()
    tied[200:] = 0.0
    jd, _ = JK.knn(jnp.asarray(tied), jnp.asarray(tied), 16)
    td, _ = TK.knn(torch.from_numpy(tied), torch.from_numpy(tied), 16)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(
        TK.mean_dist3_sq(torch.from_numpy(pts)).numpy(),
        np.asarray(JK.mean_dist3_sq(jnp.asarray(pts))), rtol=1e-5)


def test_smooth_features_match():
    """With trase_tpu's permutation injected and with every slot (no
    key): values and gradients within 1e-6. The port's own draw of
    int(K * SMOOTH_DROPOUT) slots runs."""
    rng = np.random.default_rng(7)
    f = rng.normal(size=(50, 32)).astype(np.float32)
    f[45:] = 0.0  # dead slots: all-zero features
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    nmap = np.array(JK.build_feature_smooth_map(jnp.asarray(pts), 16))
    key = jax.random.PRNGKey(3)
    perm = np.array(jax.random.permutation(key, 16)[:8])
    w = rng.normal(size=(50, 32)).astype(np.float32)
    for jkey, tperm in ((key, torch.from_numpy(perm)), (None, None)):
        ref, rg = jax.value_and_grad(lambda x: jnp.sum(
            JK.smooth_features(x, jnp.asarray(nmap), jkey) * w))(
                jnp.asarray(f))
        x = torch.from_numpy(f).requires_grad_(True)
        out = TK.smooth_features(
            x, TK.transpose_smooth_map(torch.from_numpy(nmap)), perm=tperm)
        g, = torch.autograd.grad((out * torch.from_numpy(w)).sum(), x)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(
            JK.smooth_features(jnp.asarray(f), jnp.asarray(nmap), jkey)),
            atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    own = TK.smooth_features(
        torch.from_numpy(f), TK.transpose_smooth_map(torch.from_numpy(nmap)),
        generator=gen)
    assert own.shape == (50, 32) and torch.isfinite(own).all()


def test_mask_files_across_packages(tmp_path):
    """save_mask_file in either package is read back by the other;
    mask_file_shape reads the shape without decoding; pad_masks and
    load_padded_masks equal trase_tpu's pad_masks."""
    rng = np.random.default_rng(8)
    masks = rng.random((3, 9, 13)) > 0.5
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JM.save_mask_file(a, masks)
    TM.save_mask_file(b, masks)
    np.testing.assert_array_equal(TM.decode_mask_file(a), masks)
    np.testing.assert_array_equal(JM.decode_mask_file(b), masks)
    assert TM.mask_file_shape(b) == JM.mask_file_shape(a) == (3, 9, 13)
    assert TM.mask_file_shape(str(tmp_path / "none.npz")) is None
    for m_max in (2, 3, 5):
        ref = JM.pad_masks(masks, m_max)
        got = TM.pad_masks(masks, m_max)
        np.testing.assert_array_equal(got.masks, ref.masks)
        np.testing.assert_array_equal(got.valid, ref.valid)
        assert got.masks.dtype == np.float32
        loaded = TM.load_padded_masks(b, m_max)
        np.testing.assert_array_equal(loaded.masks, ref.masks)
    assert TM.load_padded_masks(str(tmp_path / "none.npz"), 3) is None
    assert not os.path.exists(str(tmp_path / "none.npz"))
