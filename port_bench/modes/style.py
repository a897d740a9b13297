"""Style cells: the port's NNFM style loop, ``Trainer.train_style`` (the
loop of ``python -m trase_tpu_torch.train_style_transfer_nnfm``), on a
trained scene, as docs/editing.md runs it: the colours of one object's
gaussians fine-tuned against a style image on VGG16 conv4_1 features.

Set-up makes the scene, the views and the deformation weights from the
seed (scene/generate.py), the style image and each gaussian's object
(scene/style.py); writes the objects as the cluster file the port's
``save_clusters`` writes and takes the styled rows from it through the
CLI's ``style_mask_from_clusters``; builds the seeded VGG16 through
conv4_1 (``VGGFeatureExtractor`` drawing its weights from the seed) and
the style features through the CLI's ``style_features``; and builds one
Trainer on the scene. It drives the loop through its first three
iterations (the window's own call), then through the warm-up
iterations, and hands the same objects to the window. With --trace 1 a
stretch of iterations runs under the profiler after the window; its
kernels are put down to the step's VGG and NNFM through the spans and
the autograd ops that launched them (``linked_profile``). The window
runs the loop until ``--seconds`` have passed and ends on a
synchronise; the rate is the iterations it completed over its length.

After the window the program is freed and the reference
(reference/style_step.py) follows the first three steps from the same
inputs, regenerated from the seed: the first step's loss, the first
gradient of features_dc and features_rest as the optimizer got it
(Adam's first moment after one step over 1 - beta1) and each leaf's
change after the three steps, by the worst leaf (modes/train.py:
compare).

A program without the style loop's entry fails at once, before any
set-up.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import json
import math
import os
import shutil
import sys
import time
import types

import numpy as np

from port_bench import harness as HB
from port_bench.counts import bounds as B
from port_bench.counts import style as CS
from port_bench.modes import train as TM
from port_bench.reference import plain as P
from port_bench.reference import style_step as RS
from port_bench.scene import generate as SG
from port_bench.scene import style as SS

CHECKED_STEPS = 3
LAYER = "conv4_1"
LEAVES = RS.LEAVES
# the step's spans whose kernels, with those of their backward ops, the
# readers count
REGIONS = {"vgg": "trase.step.vgg", "nnfm": "trase.step.loss"}


class _Stop(Exception):
    """Raised from on_iteration to end the loop when the window closes."""


def entry():
    """The loop's style entry; fails at once where the program has none."""
    from trase_tpu_torch.engine import loop as L

    if not hasattr(L.Trainer, "train_style"):
        raise RuntimeError("this program has no style loop "
                           "(engine/loop.py: Trainer.train_style)")
    return L.Trainer.train_style


def cluster_dir() -> str:
    """Where a style cell writes its scene's cluster file: a fixed path
    under the run's TMPDIR."""
    return os.path.join(os.environ.get("TMPDIR", "/tmp"), "port_bench_style")


def style_rows(torch, cfg: dict, seed: int, alive, dev):
    """The styled rows as the CLI selects them: the scene's objects
    written as clusters.pt (the port's save_clusters), read back through
    style_mask_from_clusters with the configuration's segment id."""
    from trase_tpu_torch.cluster import save_clusters
    from trase_tpu_torch.train_style_transfer_nnfm import \
        style_mask_from_clusters

    ids = SS.object_ids(cfg["scene"], cfg["n_alive"], seed, dev)
    path = os.path.join(cluster_dir(), "clusters.pt")
    shutil.rmtree(cluster_dir(), ignore_errors=True)
    save_clusters(path, ids.cpu().numpy(),
                  np.zeros((ids.shape[0], 3), np.float32))
    return style_mask_from_clusters(path, cfg["capacity"],
                                    [cfg["style"]["segment_id"]], alive)


def build(torch, cfg: dict, traffic: dict, seed: int, dev):
    """The scene, views, VGG, style features, styled rows and a Trainer."""
    from trase_tpu_torch.config import (ModelParams, OptimizationParams,
                                        PipelineParams)
    from trase_tpu_torch.data.cameras import Camera
    from trase_tpu_torch.engine import loop as L
    from trase_tpu_torch.engine import trainer as T
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.vgg import VGG16_BLOCKS, VGGFeatureExtractor
    from trase_tpu_torch.ops.rasterize import RasterConfig
    from trase_tpu_torch.train_style_transfer_nnfm import style_features

    params, alive = SG.make_gaussians(cfg["scene"], cfg["capacity"],
                                      cfg["n_alive"], cfg["sh_degree"],
                                      cfg["feature_dim"], seed, dev)
    weights = SG.make_deform_weights(cfg["deform"], seed, dev)
    views = SG.make_views(cfg, traffic)
    cams = [Camera(uid=i, colmap_id=i, R=v["R"], T=v["T"], fovx=v["fovx"],
                   fovy=v["fovy"], image=None, image_name=v["name"],
                   image_path=None, image_width=v["width"],
                   image_height=v["height"], fid=v["fid"])
            for i, v in enumerate(views)]
    zeros = torch.zeros(cfg["capacity"], device=dev)
    aux = G.GaussianAux(alive=alive, max_radii2d=zeros,
                        xyz_gradient_accum=zeros.clone(), denom=zeros.clone())
    gp = G.GaussianParams(**params)
    scene = types.SimpleNamespace(
        gaussian_params=gp, gaussian_aux=aux, spatial_lr_scale=5.0,
        cameras_extent=float(cfg["rig"]["radius"]) * 1.1,
        get_train_cameras=lambda: cams, get_test_cameras=lambda: [])
    ds = ModelParams(sh_degree=cfg["sh_degree"], model_path="",
                     is_blender=False, is_6dof=False)
    trainer = L.Trainer(ds, OptimizationParams(**cfg["recipe"]),
                        PipelineParams(), scene, seed=seed, device=dev,
                        raster_cfg=RasterConfig(pairs_per_gaussian=int(
                            traffic["pairs_per_gaussian"])))
    shapes = [tuple(t.shape) for t in trainer.state.deform]
    if shapes != [tuple(w.shape) for w in weights]:
        raise RuntimeError(f"the port's deform MLP has shapes {shapes}, the "
                           "configuration's differ")
    trainer.state = T.init_train_state(gp, aux, weights)
    trainer.active_sh_degree = trainer.max_sh_degree
    vgg = VGGFeatureExtractor([LAYER], VGG16_BLOCKS, seed=seed, device=dev)
    image = torch.from_numpy(SS.style_image(cfg["style"], seed)).to(dev)
    index = {id(c.to_render_camera(dev)): i for i, c in enumerate(cams)}
    return types.SimpleNamespace(
        trainer=trainer, T=T, params=params, alive=alive, weights=weights,
        views=views, cams=cams, index=index, dev=dev, vgg=vgg,
        ref_feats=style_features(vgg, image),
        style_mask=style_rows(torch, cfg, seed, alive, dev))


def drive(run, first_iter: int, n: int, on_iteration=None) -> int:
    """n iterations of the loop's style entry from first_iter; returns
    the last iteration."""
    run.trainer.train_style(run.vgg, run.ref_feats, run.style_mask,
                            first_iter, first_iter + n, progress=False,
                            on_iteration=on_iteration)
    return first_iter + n


@contextlib.contextmanager
def recording(run, calls: list):
    """Record each step call's inputs in `calls`: the view, its time, the
    pair budget and the SH degree."""
    T = run.T
    step_fn = T.style_phase_step

    def step(*args, **kwargs):
        calls.append({"view": run.index[id(args[1])], "fid": float(args[4]),
                      "K": int(kwargs["raster_cfg"].pairs_per_gaussian),
                      "sh_degree": int(kwargs["sh_degree"])})
        return step_fn(*args, **kwargs)

    T.style_phase_step = step
    try:
        yield
    finally:
        T.style_phase_step = step_fn


def checked_steps(torch, run, first_iter: int) -> dict:
    """The loop's first CHECKED_STEPS iterations; returns the calls'
    inputs and the program's readings."""
    calls, losses, first, change = [], [], {}, {}
    start = [run.params[k] for k in LEAVES]

    def on_iteration(trainer, it, metrics):
        calls[-1]["iteration"] = it
        losses.append(metrics["loss"])
        p, o = trainer.state.params, trainer.state.opt
        if it == first_iter + 1:
            first.update({k: TM._norm(getattr(o, k).mu) / 0.1
                          for k in LEAVES})
        if it == first_iter + CHECKED_STEPS:
            change.update({k: TM._norm(getattr(p, k) - s)
                           for k, s in zip(LEAVES, start)})

    with recording(run, calls):
        drive(run, first_iter, CHECKED_STEPS, on_iteration)
    return {"calls": calls, "losses": [float(x) for x in losses],
            "first": first, "change": change,
            "skipped": int(run.trainer.skipped)}


def window(torch, run, first_iter: int, seconds: float):
    """The loop until `seconds` have passed; returns (iterations,
    seconds, per-iteration host intervals)."""
    stamps = []
    t0 = time.perf_counter()

    def on_iteration(trainer, it, metrics):
        now = time.perf_counter()
        stamps.append(now)
        if now - t0 >= seconds:
            raise _Stop

    try:
        drive(run, first_iter, 1 << 40, on_iteration)
    except _Stop:
        pass
    HB.sync(torch, run.dev)
    dt = time.perf_counter() - t0
    return len(stamps), dt, np.diff([t0] + stamps).tolist()


# ------------------------------------------------------------ profiling


def linked_profile(torch, fn, trace_dir: str, dev) -> dict:
    """fn() under torch.profiler, as harness.profile_stretch runs it,
    with each region's device seconds beside the profile: the time the
    device spent on the kernels launched inside the region's span (the
    forward) and inside an autograd op whose sequence number is that of
    a forward op of the span (its backward, on autograd's own thread)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "stretch.json")
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    HB.sync(torch, dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        HB.sync(torch, dev)
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = {"device": [], "host": [], "window_s": window_s}
    spans = {r: [] for r in REGIONS}  # (tid, start, end)
    ops = []  # (tid, start, end, sequence number)
    launches, kernels = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s, d = float(e["ts"]), float(e["dur"])
        args = e.get("args") or {}
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            out["device"].append((s, s + d, name))
            kernels.append((args.get("correlation"), s, s + d))
            continue
        if cat not in ("cpu_op", "cuda_runtime", "cuda_driver",
                       "user_annotation"):
            continue
        out["host"].append((s, s + d, name))
        tid = e.get("tid")
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (tid, s)
        elif cat == "user_annotation":
            for r, span in REGIONS.items():
                if name == span:
                    spans[r].append((tid, s, s + d))
        elif cat == "cpu_op" and "Sequence number" in args:
            ops.append((tid, s, s + d, args["Sequence number"]))
    out["device"].sort()
    out["host"].sort()
    out["regions_s"] = attribute(spans, ops, launches, kernels)
    return out


def _inside(intervals, tid, t) -> bool:
    return any(i_tid == tid and s <= t <= e for i_tid, s, e in intervals)


def attribute(spans: dict, ops: list, launches: dict, kernels: list) -> dict:
    """Device seconds of each region's kernels (linked_profile): the
    union of their intervals, so that kernels running side by side
    count once."""
    seqs = {r: {q for tid, s, _, q in ops if _inside(spans[r], tid, s)}
            for r in spans}
    owner = {q: r for r, qs in seqs.items() for q in qs}
    by_tid: dict = {}
    for tid, s, e, q in sorted(ops, key=lambda o: o[1]):
        if q in owner:
            by_tid.setdefault(tid, []).append((s, e, owner[q]))
    starts = {tid: [o[0] for o in v] for tid, v in by_tid.items()}
    found = {r: [] for r in spans}
    for corr, k_start, k_end in kernels:
        if corr not in launches:
            continue
        tid, t = launches[corr]
        region = next((r for r in spans if _inside(spans[r], tid, t)), None)
        if region is None and tid in by_tid:
            # the innermost linked op open at the launch, on its thread
            v = by_tid[tid]
            for j in range(bisect.bisect_right(starts[tid], t) - 1,
                           max(-1, bisect.bisect_right(starts[tid], t) - 65),
                           -1):
                if v[j][1] >= t:
                    region = v[j][2]
                    break
        if region is not None:
            found[region].append((k_start, k_end))
    out = {}
    for r, intervals in found.items():
        busy, end = 0.0, -math.inf
        for k_start, k_end in sorted(intervals):
            busy += max(0.0, k_end - max(k_start, end))
            end = max(end, k_end)
        out[r] = busy * 1e-6
    return out


def stretch(torch, run, first_iter: int, n: int, trace_dir: str):
    """n iterations under the profiler; returns the profile, each call's
    inputs and the NNFM calls the counter counted."""
    from trase_tpu_torch.utils import trace

    calls = []
    before = dict(trace.counter("nnfm"))
    with recording(run, calls):
        prof = linked_profile(
            torch, lambda: drive(run, first_iter, n), trace_dir, run.dev)
    nnfm = {k: v - before.get(k, 0) for k, v in trace.counter("nnfm").items()
            if v != before.get(k, 0)}
    return prof, calls, nnfm


def count_work(torch, cfg: dict, run, calls: list, nnfm: dict) -> dict:
    """The profiled steps' counted work: VGG's forward and input
    gradient, the NNFM's products (from the counter), and the whole
    step's operations at each precision's peak: the MLP's forward (no
    gradient) and the compositor's 4-value forward with residuals and its
    full backward (bounds.py, by the benchmark's own binning) beside
    them."""
    dcfg = cfg["deform"]
    H, W = cfg["image_height"], cfg["image_width"]
    tiles = -(-H // 16) * -(-W // 16)
    n_alive = int(run.alive.sum())
    in_dim = 3 * (1 + 2 * dcfg["multires"]) + 1 + 2 * dcfg["t_multires"]
    st = run.trainer.state.params
    state = {k: getattr(st, k) for k in ("xyz", "scaling", "rotation",
                                         "opacity", "features_dc",
                                         "features_rest")}
    vgg = CS.vgg_step_flops(H, W) * len(calls)
    nn = CS.nnfm_flops(nnfm)
    bf16, f32 = 0.0, vgg + nn
    with torch.no_grad():
        for c in calls:
            v = run.views[c["view"]]
            view = P.View(P.world_view_matrix(v["R"], v["T"]), v["fovx"],
                          v["fovy"], H, W, run.dev)
            n = state["xyz"].shape[0]
            t = torch.full((n, 1), c["fid"], device=run.dev)
            d = P.deform_mlp(run.trainer.state.deform, state["xyz"], t,
                             dcfg["D"], dcfg["multires"], dcfg["t_multires"],
                             hidden_dtype=torch.bfloat16)
            proj = P.project(view, *P.deformed_gaussians(state, run.alive,
                                                          *d),
                             sh_degree=c["sh_degree"])
            counts = {"evaluated": 0, "contributing": 0, "pairs": 0}
            P.composite(P.bin_pairs(proj, H, W, c["K"]), *P.payload_of(proj),
                        H, W, counts=counts)
            _, fo = B.composite_fwd_work(counts, 4, H, W, tiles, True)
            _, bo = B.composite_bwd_work(counts, 4, H, W, tiles, n, c["K"])
            bf16 += 2 * n_alive * B.mlp_hidden_macs(in_dim)
            f32 += 2 * n_alive * 256 * 10 + fo + bo
    k = max(len(calls), 1)
    return {"vgg_bound_s": vgg / B.F32_FLOPS_PER_S,
            "nnfm_bound_s": nn / B.F32_FLOPS_PER_S,
            "nnfm_calls": {",".join(map(str, key)): v
                           for key, v in nnfm.items()},
            "peak_s_per_step": CS.peak_s(bf16, f32) / k}


# ----------------------------------------------------------- the check


def reference_inputs(torch, cfg: dict, traffic: dict, seed: int,
                     calls: list, dev, tf32: bool = False) -> dict:
    """reference/style_step.py: run_steps' inputs, regenerated from the
    seed: the scene, the deformation weights, the VGG16 weights, the
    style image's features, the styled live rows and each call's step."""
    P.plain_precision()
    params, alive = SG.make_gaussians(cfg["scene"], cfg["capacity"],
                                      cfg["n_alive"], cfg["sh_degree"],
                                      cfg["feature_dim"], seed, dev)
    views = SG.make_views(cfg, traffic)
    H, W = cfg["image_height"], cfg["image_width"]
    vgg = RS.vgg_weights(seed, dev)
    with torch.no_grad():
        img = torch.from_numpy(SS.style_image(cfg["style"], seed)).to(dev)
        style = RS.vgg_conv4_1(vgg, img, tf32)
    ids = SS.object_ids(cfg["scene"], cfg["n_alive"], seed, dev)
    rows = torch.zeros_like(alive)
    rows[:ids.shape[0]] = ids == cfg["style"]["segment_id"]
    steps = []
    for c in calls:
        v = views[c["view"]]
        steps.append(dict(c, view=P.View(P.world_view_matrix(v["R"], v["T"]),
                                          v["fovx"], v["fovy"], H, W, dev)))
    return {"params": params, "alive": alive,
            "deform": SG.make_deform_weights(cfg["deform"], seed, dev),
            "vgg": vgg, "style_feats": style.reshape(style.shape[0], -1),
            "row_mask": rows & alive, "steps": steps,
            "deform_cfg": cfg["deform"], "recipe": cfg["recipe"],
            "bg": torch.zeros(3, device=dev)}


def reference_run(torch, cfg: dict, traffic: dict, seed: int, calls: list,
                  dev, tf32: bool = False, fault=None) -> dict:
    """The reference's losses, first-gradient norms and change norms."""
    inputs = reference_inputs(torch, cfg, traffic, seed, calls, dev, tf32)
    losses, first, now = RS.run_steps(**inputs, tf32=tf32, fault=fault)
    start = inputs["params"]
    return {"losses": losses,
            "first": {k: TM._norm(first[k]) for k in LEAVES},
            "change": {k: TM._norm(now[k] - start[k]) for k in LEAVES}}


def run(torch, ctx) -> dict:
    """One run of a style cell; returns the result and the check."""
    entry()
    cfg, traffic, args = ctx.cfg, ctx.traffic, ctx.args
    # the first iteration the loop runs: the CLI's --load_iteration is one
    # less
    first_iter = int(traffic["first_iteration"]) - 1
    marks, memory = [time.perf_counter()], []

    def mark():
        HB.sync(torch, ctx.device)
        marks.append(time.perf_counter())
        memory.append(HB.memory_gb(torch, ctx.device))

    run_ = build(torch, cfg, traffic, args.seed, ctx.device)
    mark()
    prog = checked_steps(torch, run_, first_iter)
    mark()
    it = first_iter + CHECKED_STEPS
    run_.params = None
    it = drive(run_, it, int(traffic["warm_up_iterations"]))
    mark()
    setup_s = marks[-1] - ctx.t_start
    print("[port_bench] set-up: start {:.3f}, build {:.3f}, checked steps "
          "{:.3f}, warm-up {:.3f} s; device GB (held, peak) after each: "
          "{}".format(marks[0] - ctx.t_start, *np.diff(marks), memory),
          file=sys.stderr)
    tr = run_.trainer
    skipped0 = int(tr.skipped)
    n_it, dt, intervals = window(torch, run_, it, args.seconds)
    it += n_it
    HB.report_rates(np.cumsum(intervals), dt, "iterations")
    failed = int(tr.skipped) - skipped0
    measure = None
    if args.trace:
        prof, calls, nnfm = stretch(torch, run_, it, int(
            traffic["traced_iterations"]), ctx.trace_dir)
    device = HB.device_record(torch, ctx.device)
    print(f"[port_bench] device GB (held, peak) after the window: "
          f"{HB.memory_gb(torch, ctx.device)}", file=sys.stderr)
    if args.trace:
        reading = HB.read_profile(prof)
        work = count_work(torch, cfg, run_, calls, nnfm)
        print(f"[port_bench] regions' device seconds {prof['regions_s']}, "
              f"work {work}", file=sys.stderr)
        measure = {"window_iterations": n_it, "window_s": dt,
                   "profile": reading, "regions_s": prof["regions_s"],
                   "work": work, "stretch_iterations": len(calls)}
        device.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
    del run_, tr
    shutil.rmtree(cluster_dir(), ignore_errors=True)
    gc.collect()
    HB.free(torch, ctx.device)

    t_check = time.perf_counter()
    ref = reference_run(torch, cfg, traffic, args.seed, prog["calls"],
                        ctx.device)
    got = TM.compare(prog, ref)
    HB.sync(torch, ctx.device)
    if prog["skipped"]:
        got["readings"]["loss_gap"] = math.inf
    result = {"attempted": n_it, "failed": failed, "device": device,
              "setup_s": setup_s, "check_s": time.perf_counter() - t_check,
              "end_to_end": {"train_it_s": n_it / dt, "setup_s": setup_s},
              "measure": measure, "readings": got["readings"],
              "detail": {"worst_leaf": got["worst"],
                         "program_losses": prog["losses"],
                         "reference_losses": ref["losses"],
                         "views": [c["view"] for c in prog["calls"]]}}
    if measure is not None:
        result["breakdown"] = {"device_ops": reading["device_ops"],
                               "idle_gaps": reading["idle_gaps"]}
    return result
