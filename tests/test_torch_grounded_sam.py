"""The port's Grounded-SAM bridge (trase_tpu_torch/ext/grounded_sam.py) and
its two callers against trase_tpu's: select_obj_ioa on seeded maps (empty
mask, ties at the threshold, every class inside), grounded_sam_mask and
text_prompt_mask raising ImportError without groundingdino /
segment_anything (each test blocks their import), the render CLI's
--text_prompt falling back
to --text_prompt_mask with trase_tpu's warning (the text-prompt objects
byte for byte those of a run with the mask alone), and the viewer's
text_select without a mask raising that ImportError, as trase_tpu's
viewer does."""
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from trase_tpu.ext import grounded_sam as JG  # noqa: E402

from trase_tpu_torch.ext import grounded_sam as TG  # noqa: E402

from test_torch_segment_cli import IT, pipeline  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _without_grounded_sam(monkeypatch):
    """The packages the bridge needs, blocked: any import of them fails."""
    for name in ("groundingdino", "segment_anything"):
        monkeypatch.setitem(sys.modules, name, None)


def _maps(case, rng):
    cm = rng.integers(0, 6, size=(24, 32))
    if case == "empty":
        return cm, np.zeros(cm.shape, bool)
    if case == "all_in":
        return cm, np.ones(cm.shape, bool)
    if case == "tied":  # 10 pixels per class, 7 of class 1, 8 of class 2
        cm = np.repeat(np.arange(4), 10).reshape(4, 10)
        m = np.zeros(cm.shape, bool)
        m[1, :7] = True
        m[2, :8] = True
        m[3, :] = True
        return cm, m
    return cm, rng.random(cm.shape) > 0.4


@pytest.mark.parametrize("case", ["empty", "tied", "all_in", "random"])
@pytest.mark.parametrize("thresh", [0.0, 0.7])
def test_select_obj_ioa_matches_trase_tpu(case, thresh):
    cm, m = _maps(case, np.random.default_rng(3))
    got = TG.select_obj_ioa(cm, m, ioa_thresh=thresh)
    assert got == JG.select_obj_ioa(cm, m, ioa_thresh=thresh)
    assert all(isinstance(c, int) for c in got)
    if case == "empty":
        assert got == []
    if case == "all_in":
        assert got == sorted(np.unique(cm).tolist())
    if case == "tied":  # IoA 0.7 is not above 0.7
        assert got == ([1, 2, 3] if thresh == 0.0 else [2, 3])


def test_bridge_raises_import_error_without_the_packages():
    img = np.zeros((3, 8, 8), np.float32)
    for call in (lambda: TG.grounded_sam_mask("a chair", img, device="cpu"),
                 lambda: TG.text_prompt_mask("a chair", img, "cpu"),
                 lambda: JG.grounded_sam_mask("a chair", img)):
        with pytest.raises(ImportError, match="groundingdino"):
            call()
    with pytest.raises(ImportError):
        TG._load_models(None, "cpu")
    # the port takes the device from its caller: no default
    with pytest.raises(TypeError):
        TG.grounded_sam_mask("a chair", img)


def test_render_text_prompt_falls_back_to_mask(pipeline, tmp_path, capsys):
    """--text_prompt beside --text_prompt_mask: Grounded-SAM is absent, so
    the render CLI warns and uses the mask; its text-prompt objects equal
    a run with the mask alone's, byte for byte."""
    from trase_tpu_torch import render as t_render
    from trase_tpu_torch.cluster import __main__ as t_cluster

    _, src, mdl, mask_png, _, mask_px = pipeline
    tag = os.path.splitext(os.path.basename(mask_png))[0]
    got, logs = {}, {}
    for name, prompt in (("mask", []), ("prompt", ["--text_prompt", tag])):
        copy = str(tmp_path / name)
        shutil.copytree(mdl, copy)
        t_cluster.main(["-m", copy, "--kmeans", "--k", "3", "--device",
                        "cpu"])
        capsys.readouterr()
        t_render.main(["-s", src, "-m", copy, "--iteration", str(IT),
                       "--skip_train", "--sh_degree", "1", "--is_blender",
                       "--eval", "--use_kmeans", "--text_prompt_mask",
                       mask_png, "--threshold",
                       str(max(int(mask_px * 0.2), 5)), "--max_per_tile",
                       "128", "--pairs_per_gaussian", "16", "--device",
                       "cpu"] + prompt)
        logs[name] = capsys.readouterr().out
        folder = os.path.join(copy, "test", f"ours_{IT}",
                              f"text_prompt_{tag}_objects")
        got[name] = {}
        for f in sorted(os.listdir(folder)):
            with open(os.path.join(folder, f), "rb") as fh:
                got[name][f] = fh.read()
    assert "Grounded-SAM unavailable" in logs["prompt"]
    assert "Grounded-SAM unavailable" not in logs["mask"]
    assert sorted(got["mask"]) == ["00000.png", "00001.png"]
    assert got["prompt"] == got["mask"]


def test_render_text_prompt_alone_selects_nothing(capsys):
    """--text_prompt without a mask file and without Grounded-SAM: the
    warning, no mask (as trase_tpu's render.py)."""
    from trase_tpu_torch import render as t_render

    args = types.SimpleNamespace(text_prompt="a chair", text_prompt_mask="")
    assert t_render._resolve_text_mask(
        args, np.zeros((3, 8, 8), np.float32), "cpu") is None
    assert "Grounded-SAM unavailable" in capsys.readouterr().out


def test_viewer_text_select_without_mask_raises_import_error():
    """text_select(text) with no mask2d asks Grounded-SAM for one on the
    current frame: ImportError in both packages' viewers (their frames
    stubbed: the bridge is reached before any other work)."""
    from trase_tpu import viewer as JV

    from trase_tpu_torch import viewer as TV

    frame = {"render": torch.zeros(3, 8, 8), "depth": torch.ones(1, 8, 8)}
    for cls in (TV.HeadlessViewer, JV.HeadlessViewer):
        fake = types.SimpleNamespace(
            cluster_ids=np.zeros(4, np.int64), device=torch.device("cpu"),
            _raw_frame=lambda: (frame, None))
        with pytest.raises(ImportError, match="groundingdino"):
            cls.text_select(fake, "the red blob")


def test_model_cache_is_keyed_by_checkpoint_and_device(monkeypatch):
    """The port caches the loaded networks per (checkpoint, device); a
    call for another device loads anew (here: the ImportError), where
    trase_tpu's single cache would hand back the first device's."""
    sentinel = object()
    monkeypatch.setattr(TG, "_models", {(None, "cpu"): sentinel})
    assert TG._load_models(None, torch.device("cpu")) is sentinel
    with pytest.raises(ImportError):
        TG._load_models(None, "cuda")
    with pytest.raises(ImportError):
        TG._load_models("other.pth", "cpu")
