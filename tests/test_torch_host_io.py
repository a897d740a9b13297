"""Port parity for host IO: trase_tpu_torch.native (the ctypes binding to
native/trase_io.cpp, built into trase_tpu_torch/build/) against
trase_tpu.native and against its own numpy paths; the native branch of
data/masks.load_padded_masks; the bits path (load_packed_masks, the
prefetcher's packed bits, ops/mask_unpack's plain version against
native.unpack_masks_padded); MaskPrefetcher against trase_tpu's; and a
short FEATURE run of the training CLI with masks read from disk, with the
prefetcher and without it: the same masks in every step and the same
final state, bit for bit.

Tolerances: bit for bit everywhere except rgba_to_rgb_f32's native path
against the numpy path (the C++ multiplies by 1/255 and may contract to
fused multiply-adds, numpy divides), within trase_tpu's 1e-6
(tests/test_native.py)."""
import os

import numpy as np
import pytest
import torch

from trase_tpu import native as j_native
from trase_tpu.data import masks as JM

from trase_tpu_torch import native as t_native
from trase_tpu_torch.data import masks as TM
from trase_tpu_torch.engine import loop as TL
from trase_tpu_torch.engine import trainer as TT
from trase_tpu_torch.ops import mask_unpack as TMU

torch.set_num_threads(2)


def test_builds_into_the_package_build_dir():
    assert t_native.available(), "g++ expected in this image"
    path = t_native.library_path()
    assert os.path.dirname(path) == t_native.BUILD_DIR
    assert os.path.exists(path)
    assert not [f for f in os.listdir(t_native.BUILD_DIR)
                if f.endswith(".tmp")]


def _packed(n, h, w, seed):
    masks = np.random.default_rng(seed).random((n, h, w)) > 0.5
    return masks, np.packbits(masks.reshape(-1).astype(np.uint8))


@pytest.mark.parametrize("n,h,w,m_max", [(7, 33, 61, 10), (7, 33, 61, 3),
                                         (5, 17, 23, 5), (1, 1, 9, 2)])
def test_unpack_masks_padded(n, h, w, m_max, monkeypatch):
    masks, packed = _packed(n, h, w, n * h)
    got = t_native.unpack_masks_padded(packed, n, h, w, m_max)
    assert got.shape == (m_max, h, w) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, j_native.unpack_masks_padded(packed, n, h, w, m_max))
    k = min(n, m_max)
    np.testing.assert_array_equal(got[:k], masks[:k].astype(np.float32))
    assert not got[k:].any()
    monkeypatch.setattr(t_native, "_load", lambda: None)
    np.testing.assert_array_equal(
        t_native.unpack_masks_padded(packed, n, h, w, m_max), got)
    with pytest.raises(ValueError, match="packed bytes"):
        t_native.unpack_masks_padded(packed[:-1], n + 1, h, w, m_max)


@pytest.mark.parametrize("channels", [4, 3])
def test_rgba_to_rgb_f32(channels, monkeypatch):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), np.uint8)
    img[0, :channels] = 0
    img[1, :channels] = 255
    bg = np.array([0.3, 0.7, 0.1], np.float32)
    got = t_native.rgba_to_rgb_f32(img, bg)
    assert got.shape == (3, 37, 53) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j_native.rgba_to_rgb_f32(img, bg))
    monkeypatch.setattr(t_native, "_load", lambda: None)
    monkeypatch.setattr(j_native, "_load", lambda: None)
    plain = t_native.rgba_to_rgb_f32(img, bg)
    np.testing.assert_array_equal(plain, j_native.rgba_to_rgb_f32(img, bg))
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="uint8"):
        t_native.rgba_to_rgb_f32(img[..., :2], bg)


def _mask_files(tmp_path, shapes, seed=0):
    rng = np.random.default_rng(seed)
    paths, stacks = [], []
    for i, (n, h, w) in enumerate(shapes):
        m = rng.random((n, h, w)) > 0.6
        p = str(tmp_path / f"m{i}.npz")
        TM.save_mask_file(p, m)
        paths.append(p)
        stacks.append(m)
    return paths, stacks


@pytest.mark.parametrize("m_max", [3, 6])
def test_load_padded_masks_native_branch(tmp_path, m_max):
    """The native branch equals the numpy route (decode then pad) and
    trase_tpu's loader bit for bit; .npy files take the numpy route."""
    paths, stacks = _mask_files(tmp_path, [(4, 19, 27), (6, 8, 40)])
    np.save(tmp_path / "m.npy", stacks[0])
    for p in paths + [str(tmp_path / "m.npy")]:
        got = TM.load_padded_masks(p, m_max)
        plain = TM.pad_masks(TM.decode_mask_file(p), m_max)
        ref = JM.load_padded_masks(p, m_max)
        for a, b in ((got, plain), (got, ref)):
            np.testing.assert_array_equal(a.masks, b.masks)
            np.testing.assert_array_equal(a.valid, b.valid)
        assert got.masks.dtype == np.float32
    assert TM.load_padded_masks(str(tmp_path / "missing.npz"), m_max) is None


def test_load_packed_masks_stops_at_the_bits(tmp_path):
    """The native container's packed bits as the file holds them, with
    (N, H, W); np.unpackbits of them is decode_mask_file's stack. Other
    containers and missing files give None."""
    paths, stacks = _mask_files(tmp_path, [(3, 5, 7), (4, 19, 27)])
    for p, m in zip(paths, stacks):
        got = TM.load_packed_masks(p)
        assert got.shape == m.shape
        np.testing.assert_array_equal(got.bits, np.load(p)["packed"])
        n, h, w = got.shape
        bits = np.unpackbits(got.bits, count=n * h * w).reshape(n, h, w)
        np.testing.assert_array_equal(bits.astype(bool),
                                      TM.decode_mask_file(p))
    np.save(tmp_path / "m.npy", stacks[0])
    np.savez(tmp_path / "plain.npz", masks=stacks[0])
    for other in ("m.npy", "plain.npz", "missing.npz"):
        assert TM.load_packed_masks(str(tmp_path / other)) is None


@pytest.mark.parametrize("n,h,w,m_max", [(3, 5, 7, 6), (70, 8, 9, 64),
                                         (0, 5, 7, 4), (7, 33, 61, 10)])
def test_unpack_masks_plain_matches_native(n, h, w, m_max):
    """ops/mask_unpack on a CPU tensor (its plain version): bits that
    cross byte boundaries, truncation past m_max, no masks at all."""
    _, packed = _packed(n, h, w, n + h)
    got = TMU.unpack_masks(torch.from_numpy(packed), n, h, w, m_max)
    ref = t_native.unpack_masks_padded(packed, n, h, w, m_max)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(ref))
    with pytest.raises(ValueError, match="packed bytes"):
        TMU.unpack_masks(torch.from_numpy(packed[:-1]), n + 1, h, w, m_max)


def test_mask_prefetcher_bits_mode(tmp_path):
    """The prefetcher yields the native files' bits as uint8 tensors,
    page-locked where CUDA is present, in submission order; other
    containers as the padded float32 stack, a missing file as None; a
    decode's error is re-raised."""
    paths, stacks = _mask_files(tmp_path, [(4, 19, 27), (2, 19, 27)])
    np.save(tmp_path / "m.npy", stacks[0])
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    order = [paths[0], str(tmp_path / "missing.npz"),
             str(tmp_path / "m.npy"), paths[1]]
    pf = TM.MaskPrefetcher(4, depth=2)
    try:
        for p in order + [str(bad)]:
            pf.submit(p)
        got = [pf.get() for _ in order]
        assert [p for p, _ in got] == order
        for i in (0, 3):
            packed = got[i][1]
            assert isinstance(packed, TM.PackedMasks)
            assert packed.bits.dtype == torch.uint8
            assert packed.bits.is_pinned() == torch.cuda.is_available()
            np.testing.assert_array_equal(packed.bits.numpy(),
                                          np.load(order[i])["packed"])
            assert packed.shape == stacks[i // 3].shape
        assert got[1][1] is None
        ref = TM.load_padded_masks(order[2], 4)
        np.testing.assert_array_equal(got[2][1].masks, ref.masks)
        with pytest.raises(Exception):
            pf.get()
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_mask_prefetcher_matches_trase_tpu(tmp_path):
    paths, _ = _mask_files(tmp_path, [(4, 19, 27), (2, 19, 27), (5, 19, 27),
                                      (3, 19, 27), (1, 19, 27), (4, 19, 27)])
    paths.insert(2, str(tmp_path / "missing.npz"))
    tp, jp = TM.MaskPrefetcher(4, depth=2), JM.MaskPrefetcher(4, depth=2)
    try:
        for p in paths:
            tp.submit(p)
            jp.submit(p)
        for p in paths:
            (tpath, got), (jpath, ref) = tp.get(), jp.get()
            assert tpath == jpath == p
            if ref is None:
                assert got is None
                continue
            # the port's prefetcher stops at a native file's bits: the
            # loop's unpack of them is trase_tpu's stack
            assert isinstance(got, TM.PackedMasks)
            n, h, w = got.shape
            np.testing.assert_array_equal(
                TMU.unpack_masks(got.bits, n, h, w, 4).numpy(), ref.masks)
            np.testing.assert_array_equal(np.arange(4) < n, ref.valid)
    finally:
        tp.close()
        jp.close()
    assert not tp._thread.is_alive()


def test_mask_prefetcher_errors_and_close(tmp_path):
    """A decode that raises is re-raised by get(); close() ends the thread
    while results wait in a full queue and jobs are still queued."""
    paths, _ = _mask_files(tmp_path, [(2, 8, 8)] * 6)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    pf = TM.MaskPrefetcher(2, depth=2)
    pf.submit(str(bad))
    with pytest.raises(Exception):
        pf.get()
    for p in paths:
        pf.submit(p)
    assert pf.get()[0] == paths[0]
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


def _run(src, mdl, prefetch, monkeypatch):
    """The train CLI on a dataset whose masks are read from disk
    (--load_mask_on_the_fly), FEATURE blocks from iteration 4, with a
    mask cache of one stack (every FEATURE step decodes). Returns
    the trainer, the masks each FEATURE step took and the prefetcher's
    gets."""
    from trase_tpu_torch import train as t_train

    seen, gets = [], []
    fstep = TT.feature_phase_step

    def feature(state, cam, masks, valid, *a, **kw):
        seen.append((masks.clone(), valid.clone()))
        return fstep(state, cam, masks, valid, *a, **kw)

    get = TM.MaskPrefetcher.get

    def counted_get(self):
        out = get(self)
        gets.append(out[0])
        return out

    monkeypatch.setattr(TT, "feature_phase_step", feature)
    monkeypatch.setattr(TM.MaskPrefetcher, "get", counted_get)
    monkeypatch.setattr(TL, "MASK_CACHE_SIZE", 1)
    monkeypatch.setattr(TL, "MASK_CACHE_CAP", 1)
    if not prefetch:
        monkeypatch.setattr(TL.Trainer, "_submit_mask_prefetch",
                            lambda self, cam: None)
    trainer = t_train.main([
        "-s", src, "-m", mdl, "--iterations", "14", "--device", "cpu",
        "--is_blender", "--sh_degree", "1", "--quiet", "--warm_up", "2",
        "--warm_up_3d_features", "4", "--iterative_opt_interval", "7",
        "--densify_from_iter", "2", "--densification_interval", "5",
        "--densify_until_iter", "9", "--opacity_reset_interval", "1000",
        "--num_sampled_pixels", "64", "--num_sampled_masks", "4",
        "--pairs_per_gaussian", "16", "--load_mask_on_the_fly",
        "--save_iterations", "14"])
    monkeypatch.undo()
    return trainer, seen, gets


def test_feature_run_with_and_without_prefetcher(tmp_path, monkeypatch):
    from trase_tpu.data.synthetic import write_synthetic_dataset

    src = str(tmp_path / "data")
    write_synthetic_dataset(src, n_train=4, n_test=1, image_size=32,
                            n_blobs=3, pts_per_blob=24)
    a, seen_a, gets_a = _run(src, str(tmp_path / "a"), True, monkeypatch)
    b, seen_b, gets_b = _run(src, str(tmp_path / "b"), False, monkeypatch)
    assert a.feature_calls == b.feature_calls == len(seen_a) == len(seen_b)
    assert len(seen_a) >= 5
    for (ma, va), (mb, vb) in zip(seen_a, seen_b):
        assert torch.equal(ma, mb) and torch.equal(va, vb)
    assert len(gets_a) >= len(seen_a) - 1 and not gets_b
    assert a._prefetcher is None  # closed when train() returned
    sa, sb = TT.train_state_to_numpy(a.state), TT.train_state_to_numpy(
        b.state)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: np.asarray(tree)}

    fa, fb = flat(sa), flat(sb)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_gt_images_convert_through_native(tmp_path):
    """The loop's GT loader: PIL's RGBA through rgba_to_rgb_f32, equal to
    trase_tpu's loader (the same library) bit for bit."""
    from PIL import Image

    img = np.random.default_rng(5).integers(0, 256, (20, 30, 4), np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(img).save(path)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    np.testing.assert_array_equal(TL._load_gt(path, bg),
                                  j_native.rgba_to_rgb_f32(img, bg))
