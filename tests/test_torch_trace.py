"""The port's spans and counters (trase_tpu_torch/utils/trace.py): off
records nothing, on nests parents and iterations (also on the mask
prefetcher's thread), every span is a user_annotation of a CPU
torch.profiler trace, a tiny CPU training run records the loop's, the
step's and the renderer's spans in every iteration of each regime, and
the cache counters count a planted cache's hits and misses, and the
mask_fetch counter the path each mask miss took: bits for a native mask
file, float32 for in-memory masks."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trase_tpu_torch.data import masks as TM  # noqa: E402
from trase_tpu_torch.engine import loop as TL  # noqa: E402
from trase_tpu_torch.ops import cuda_lib  # noqa: E402
from trase_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

STEP = ["trase.step", "trase.step.deform", "trase.step.render",
        "trase.step.loss", "trase.step.backward", "trase.step.adam",
        "trase.render.project", "trase.render.bin", "trase.render.composite",
        "trase.composite.backward"]
EVERY_ITERATION = ["trase.iteration", "trase.loop.fetch"] + STEP


@pytest.fixture
def tracing():
    """Spans on for the test, off and cleared after it."""
    trace.take()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.set_iteration(None)
        trace.take()


def test_off_records_nothing_and_shares_one_object():
    assert not trace.enabled()
    a, b = trace.span("trase.a"), trace.span("trase.b", iteration=3)
    assert a is b is trace.NOOP
    with a, trace.span("trase.c"):
        pass
    assert trace.take() == []


def test_on_nests_parents_and_iterations(tracing, tmp_path):
    trace.set_iteration(5)
    with trace.span("trase.a"):
        with trace.span("trase.b"):
            pass
        with trace.span("trase.c", iteration=2):
            pass
    # a decode on the prefetcher's thread carries the submitting iteration
    path = str(tmp_path / "m.npy")
    np.save(path, np.ones((2, 4, 6), bool))
    pf = TM.MaskPrefetcher(3, depth=2)
    try:
        trace.set_iteration(7)
        pf.submit(path)
        trace.set_iteration(8)
        got_path, got = pf.get()
    finally:
        pf.close()
    assert got_path == path and got.masks.shape == (3, 4, 6)
    spans = {s.name: s for s in trace.take()}
    a, b, c = (spans[f"trase.{n}"] for n in "abc")
    assert [(s.parent, s.iteration) for s in (a, b, c)] == [
        (None, 5), ("trase.a", 5), ("trase.a", 2)]
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= a.end_ns
    assert {a.thread, b.thread, c.thread} == {"MainThread"}
    d = spans["trase.masks.decode"]
    assert (d.parent, d.iteration, d.thread) == (None, 7, "mask-prefetch")
    summary = trace.summarize([a, b, c])
    assert summary["trase.a"]["count"] == 1
    assert summary["trase.a"]["self_ms"] == pytest.approx(
        summary["trase.a"]["total_ms"] - summary["trase.b"]["total_ms"]
        - summary["trase.c"]["total_ms"])


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_annotations(on, tmp_path):
    """Under a CPU torch.profiler every span is a user_annotation around
    the ops it encloses, whether spans are recorded or not."""
    from torch.profiler import ProfilerActivity, profile

    trace.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("trase.outer"):
                with trace.span("trase.inner"):
                    torch.ones(8).mul_(2.0)
        recorded = trace.take()
    finally:
        trace.enable(False)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"
           and e["name"].startswith("trase.")}
    assert set(ann) == {"trase.outer", "trase.inner"}
    o, i = ann["trase.outer"], ann["trase.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert any(e.get("name") == "aten::mul_" and e["ts"] >= i["ts"]
               for e in events)
    assert [s.name for s in recorded] == (
        ["trase.inner", "trase.outer"] if on else [])


def test_layout_launches_is_the_counter():
    assert cuda_lib.LAYOUT_LAUNCHES is trace.counter("layout_launches")
    assert TL.CACHE_COUNTS is trace.counter("cache")


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """The train CLI on the CPU with spans on, its phase machine
    alternating blocks of three steps: GAUSSIAN 1-3 and 7-9, FEATURE 4-6
    and 10-12 (masks read from disk by the prefetcher into a mask cache of
    one stack); returns the trainer, the spans by iteration and the cache
    counter's change."""
    import contextlib
    import io

    from trase_tpu_torch import train as t_train
    from trase_tpu_torch.data.synthetic import write_synthetic_dataset

    base = tmp_path_factory.mktemp("traced")
    src = str(base / "data")
    write_synthetic_dataset(src, n_train=3, n_test=1, image_size=32,
                            n_blobs=2, pts_per_blob=24, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(TL, "MASK_CACHE_SIZE", 1)
    mp.setattr(TL, "MASK_CACHE_CAP", 1)
    before = dict(TL.CACHE_COUNTS)
    trace.take()
    trace.enable(True)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            tr = t_train.main([
                "-s", src, "-m", str(base / "mdl"), "--iterations", "12",
                "--device", "cpu", "--is_blender", "--eval", "--sh_degree",
                "1", "--quiet", "--warm_up", "2", "--warm_up_3d_features", "3",
                "--iterative_opt_interval", "2", "--densify_from_iter",
                "100", "--num_sampled_pixels", "64", "--num_sampled_masks",
                "4", "--pairs_per_gaussian", "16", "--load_mask_on_the_fly",
                "--save_iterations", "12"])
        spans = trace.take()
    finally:
        trace.enable(False)
        mp.undo()
    counts = {k: TL.CACHE_COUNTS.get(k, 0) - before.get(k, 0)
              for k in TL.CACHE_COUNTS}
    by_it: dict = {}
    for s in spans:
        by_it.setdefault(s.iteration, []).append(s)
    return tr, by_it, counts


@pytest.mark.parametrize("regime", ["gaussian", "feature"])
def test_training_records_spans_every_iteration(traced_run, regime):
    tr, by_it, counts = traced_run
    its = [1, 2, 3, 7, 8, 9] if regime == "gaussian" else [4, 5, 6, 10,
                                                           11, 12]
    assert tr.step_calls == tr.feature_calls == 6
    for it in its:
        names = [s.name for s in by_it[it]]
        missing = [n for n in EVERY_ITERATION if n not in names]
        assert not missing, (it, missing)
        assert names.count("trase.step") == 1
        assert ("trase.loop.read_metrics" in names) == (it == 10)
        parents = {s.name: s.parent for s in by_it[it]
                   if s.thread == "MainThread"}
        assert parents["trase.iteration"] is None
        for child, parent in [("trase.loop.fetch", "trase.iteration"),
                              ("trase.step", "trase.iteration"),
                              ("trase.step.render", "trase.step"),
                              ("trase.render.bin", "trase.step.render"),
                              ("trase.composite.backward",
                               "trase.step.backward")]:
            assert parents[child] == parent, (it, child)
    if regime == "gaussian":
        # each of the three views' GT uploads once, at its first fetch
        uploads = sum(s.name == "trase.loop.fetch.upload"
                      for it in its for s in by_it[it])
        assert uploads == counts[("gt", "miss")] == 3
        assert counts[("gt", "hit")] == 3
        return
    # FEATURE: a cache of one stack holds a view only when it repeats
    uploads = [it for it in its for s in by_it[it]
               if s.name == "trase.loop.fetch.upload"]
    assert len(uploads) == counts[("masks", "miss")] >= 3
    assert counts.get(("masks", "hit"), 0) == len(its) - len(uploads)
    for it in uploads:
        assert "trase.loop.fetch.wait" in [s.name for s in by_it[it]]
    decodes = [s for spans in by_it.values() for s in spans
               if s.name == "trase.masks.decode"]
    assert decodes and all(s.thread in ("mask-prefetch", "MainThread")
                           for s in decodes)
    # the prefetcher decodes the next view's masks during this iteration
    assert any(s.thread == "mask-prefetch" and s.iteration in its
               for s in decodes)


def test_cache_counters_count_a_planted_cache(traced_run):
    tr, _, _ = traced_run
    cams = tr.scene.get_train_cameras()
    before = dict(TL.CACHE_COUNTS)

    def delta():
        return {k: TL.CACHE_COUNTS.get(k, 0) - before.get(k, 0)
                for k in TL.CACHE_COUNTS if TL.CACHE_COUNTS[k] != before.get(
                    k, 0)}

    tr._gt_cache.clear()
    tr._gt_cache[(cams[0].image_path or cams[0].image_name,
                  cams[0].image_width, cams[0].image_height)] = torch.zeros(3)
    for cam in (cams[0], cams[1], cams[1], cams[0], cams[2]):
        tr._gt_image(cam)
    assert delta() == {("gt", "hit"): 3, ("gt", "miss"): 2}
    before = dict(TL.CACHE_COUNTS)
    tr._mask_cache.clear()
    tr.mask_cache_size = 8
    planted = (torch.zeros(1), torch.ones(1, dtype=torch.bool))
    tr._mask_cache[cams[2].image_path or cams[2].image_name] = planted
    got = [tr._masks_for(cam) for cam in (cams[2], cams[0], cams[2],
                                          cams[0], cams[1])]
    assert got[0] is planted and got[2] is planted
    assert delta() == {("masks", "hit"): 3, ("masks", "miss"): 2}


def test_mask_fetch_counts_the_float32_path_on_the_cpu(traced_run):
    """A camera's in-memory masks take the host path: the miss counts under
    mask_fetch ("float32", ...) with the stack's and the validity vector's
    bytes, and a later fetch returns the cached tuple itself."""
    import dataclasses

    tr, _, _ = traced_run
    assert TL.MASK_FETCH is trace.counter("mask_fetch")
    disk = tr.scene.get_train_cameras()[0]
    cam = dataclasses.replace(disk, masks=TM.decode_mask_file(disk.mask_path))
    tr._mask_cache.clear()
    before = dict(TL.MASK_FETCH)
    entry = tr._masks_for(cam)
    masks, valid = entry
    delta = {k: TL.MASK_FETCH[k] - before.get(k, 0) for k in TL.MASK_FETCH
             if TL.MASK_FETCH[k] != before.get(k, 0)}
    assert delta == {("float32", "miss"): 1,
                     ("float32", "bytes"): masks.numel() * 4 + valid.numel()}
    ref = TM.load_padded_masks(disk.mask_path, tr._m_max)
    assert torch.equal(masks, torch.from_numpy(ref.masks))
    assert torch.equal(valid, torch.from_numpy(ref.valid))
    assert tr._masks_for(cam) is entry
    assert dict(TL.MASK_FETCH) == {**before, **{k: before.get(k, 0) + v
                                                for k, v in delta.items()}}


def test_bits_path_caches_the_float32_stack(traced_run):
    """A CPU trainer's mask files take the bits path (the unpack is its
    plain version there): misses through the prefetcher and inline count
    under mask_fetch ("bits", ...) with the packed bytes, and cache the
    host path's stack and validity exactly."""
    tr, _, _ = traced_run
    cams = tr.scene.get_train_cameras()
    tr._mask_cache.clear()
    tr._prepare_mask_meta(cams)
    before = dict(TL.MASK_FETCH)
    try:
        tr._submit_mask_prefetch(cams[0])
        got = [tr._masks_for(cams[0]), tr._masks_for(cams[1])]
    finally:
        tr._close_prefetcher()
    packed = [TM.load_packed_masks(c.mask_path).bits.size for c in cams[:2]]
    assert TL.MASK_FETCH[("bits", "miss")] - before.get(("bits", "miss"),
                                                        0) == 2
    assert TL.MASK_FETCH[("bits", "bytes")] - before.get(
        ("bits", "bytes"), 0) == sum(packed)
    assert TL.MASK_FETCH.get(("float32", "miss")) == before.get(
        ("float32", "miss"))
    for cam, (masks, valid) in zip(cams, got):
        ref = TM.load_padded_masks(cam.mask_path, tr._m_max)
        assert masks.dtype == torch.float32 and valid.dtype == torch.bool
        assert torch.equal(masks, torch.from_numpy(ref.masks))
        assert torch.equal(valid, torch.from_numpy(ref.valid))
