"""The port's mask CLI (python -m trase_tpu_torch.extract_masks) against
the root extract_masks.py: tests/test_interop.py's two --from_pt cases
through the port, --from_dir on label-map PNGs and on per-image
subdirectories of binary PNGs with the .npz, --save_pt and
--save_to_tensor outputs of both CLIs equal once decoded (the .npz and .pt
containers carry write times, so their bytes differ), and the SAM branch
without segment_anything exiting with the root's message."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import extract_masks as root_cli  # noqa: E402

from trase_tpu.data.masks import decode_mask_file as j_decode  # noqa: E402

from trase_tpu_torch import extract_masks as port_cli  # noqa: E402
from trase_tpu_torch.data.masks import decode_mask_file  # noqa: E402


def test_extract_masks_from_pt_conversion(tmp_path):
    """--from_pt: reference .pt -> native .npz."""
    rng = np.random.default_rng(4)
    masks = rng.random((2, 8, 8)) > 0.5
    src = tmp_path / "pt_masks"
    src.mkdir()
    torch.save(torch.from_numpy(masks), str(src / "0001.pt"))
    out = tmp_path / "scene"
    port_cli.main(["--from_pt", str(src), "--output", str(out)])
    dec = decode_mask_file(str(out / "masks" / "0001.npz"))
    np.testing.assert_array_equal(dec, masks)
    np.testing.assert_array_equal(j_decode(str(out / "masks" / "0001.npz")),
                                  masks)


def test_extract_masks_save_to_tensor(tmp_path):
    """--save_to_tensor writes the reference's raw bool tensor .pt
    (reference extract_masks.py:43,87-89), read back by decode_mask_file."""
    rng = np.random.default_rng(5)
    masks = rng.random((3, 6, 9)) > 0.5
    src = tmp_path / "pt_masks"
    src.mkdir()
    torch.save(torch.from_numpy(masks), str(src / "a.pt"))
    out = tmp_path / "scene"
    port_cli.main(["--from_pt", str(src), "--output", str(out),
                   "--save_to_tensor"])
    obj = torch.load(str(out / "masks" / "a.pt"), map_location="cpu",
                     weights_only=False)
    assert torch.is_tensor(obj) and obj.dtype == torch.bool
    np.testing.assert_array_equal(
        decode_mask_file(str(out / "masks" / "a.pt")), masks)


def _label_dir(tmp_path, rng):
    """Label-map PNGs (gray level = object, 0 = none; one map empty) and
    per-image subdirectories of binary PNGs."""
    from PIL import Image

    src = tmp_path / "labels"
    src.mkdir()
    want = {}
    for i in range(3):
        label = np.zeros((12, 16), np.uint8)
        if i < 2:
            for level in rng.choice(np.arange(1, 255), 3, replace=False):
                y, x = rng.integers(0, 10), rng.integers(0, 13)
                label[y:y + 3, x:x + 4] = level
            vals = [v for v in np.unique(label) if v != 0]
            want[f"{i:04d}"] = np.stack([label == v for v in vals])
        Image.fromarray(label).save(src / f"{i:04d}.png")
    for name in ("view_a", "view_b"):
        d = src / name
        d.mkdir()
        stack = rng.random((2, 12, 16)) > 0.6
        for k, m in enumerate(stack):
            Image.fromarray((m * 255).astype(np.uint8)).save(d / f"{k}.png")
        want[name] = stack
    return src, want


@pytest.mark.parametrize("fmt", [[], ["--save_pt"], ["--save_to_tensor"]],
                         ids=["npz", "save_pt", "save_to_tensor"])
def test_from_dir_matches_root(tmp_path, fmt):
    src, want = _label_dir(tmp_path, np.random.default_rng(6))
    outs = {}
    for name, cli in (("root", root_cli), ("port", port_cli)):
        out = tmp_path / name
        cli.main(["--from_dir", str(src), "--output", str(out)] + fmt)
        outs[name] = out / "masks"
    files = sorted(os.listdir(outs["port"]))
    assert files == sorted(os.listdir(outs["root"]))
    ext = ".npz" if not fmt else ".pt"
    assert files == sorted(k + ext for k in want)  # the empty map: no file
    for f in files:
        a = decode_mask_file(str(outs["root"] / f))
        b = decode_mask_file(str(outs["port"] / f))
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, want[f[:-len(ext)]])
    if fmt == ["--save_pt"]:  # the payload dicts equal, not just decoded
        a = torch.load(str(outs["root"] / files[0]), weights_only=False)
        b = torch.load(str(outs["port"] / files[0]), weights_only=False)
        assert sorted(a) == sorted(b) == ["H", "N", "W", "masks"]
        assert [a[k] for k in "NHW"] == [b[k] for k in "NHW"]
        assert torch.equal(torch.as_tensor(b["masks"]),
                           torch.as_tensor(a["masks"]))


def test_sam_branch_without_segment_anything(tmp_path, monkeypatch):
    """No segment_anything: both CLIs exit with the same message; without
    --img_path, with the root's usage message."""
    monkeypatch.setitem(sys.modules, "segment_anything", None)
    img = tmp_path / "imgs"
    img.mkdir()
    msgs = []
    for cli in (root_cli, port_cli):
        with pytest.raises(SystemExit) as e:
            cli.main(["--img_path", str(img), "--output",
                      str(tmp_path / "out")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("segment_anything unavailable") and \
        "--from_dir / --from_pt" in msgs[1]
    for cli in (root_cli, port_cli):
        with pytest.raises(SystemExit, match="--img_path required"):
            cli.main(["--output", str(tmp_path / "out")])
