"""Training cells: the port's loop, ``Trainer.train``, in one regime of
the published schedule: GAUSSIAN steps past densification, or a FEATURE
block (values-only), whose views' SAM masks are written as mask files
that the loop's own prefetcher reads.

Set-up makes the scene, the views, their ground truth (held in host
memory, as the loop's cameras hold them; GAUSSIAN) or mask files
(FEATURE) from the seed, and builds one Trainer on them. It loads every
view once through the loop's own fetch path, with no step, so that the
GT or mask cache holds what it holds in a long run; drives the trainer
through its first three steps by ``train`` (the window's own call), then
through more steps with the port's pair-budget controller consulted
after each, and hands the same object to the window. With --trace 1 a
stretch of steps runs under the profiler after the window, or before it
where the traffic says so. The window runs ``train``
until ``--seconds`` have passed and ends on a synchronise; the rate is
the iterations it completed over its length.

After the window the program's state is freed and the reference follows
the first three steps from the same inputs (regenerated from the seed):
the first step's loss, the first gradient of every trained leaf as the
optimizer got it (Adam's first moment after one step over 1 - beta1) and
each leaf's change after the three steps, by the worst leaf.

A cell whose limits name the densification's numbers also has its
checked steps' densification statistics compared (``densify_stats_gap``)
and records the first densification round of its warm-up: the state the
round started from and the one it returned, in host memory, and the
split samples, which the harness draws from the round's own generator as
the round would and hands to it. After the window the plain round
(reference/densify.py) runs on the recorded input with the same samples
and the configuration's thresholds (``densify_rows_gap``,
``densify_gap``). That round starts from the program's own state after
thousands of iterations, which no reference can reach; the checked steps
check the step that made it.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import shutil
import sys
import time
import types

import numpy as np

from port_bench import harness as HB
from port_bench.counts import bounds as B
from port_bench.reference import densify as RD
from port_bench.reference import feature_step as RF
from port_bench.reference import plain as P
from port_bench.reference import train_step as RS
from port_bench.scene import generate as SG

CHECKED_STEPS = 3
# threads that deflate the mask files in set-up
MASK_WRITERS = 4


class _Stop(Exception):
    """Raised from on_iteration to end ``train`` when the window closes."""


def _norm(t) -> float:
    return float(t.double().norm())


def leaf_names(n_weights: int, regime: str = "gaussian") -> list:
    """The leaves the regime trains: the six gaussian fields and the MLP's
    tensors (GAUSSIAN), or the segmentation features (FEATURE)."""
    if regime == "feature":
        return ["gaussian_features"]
    return list(RS.FIELDS) + [f"deform.{i // 2}.{'wb'[i % 2]}"
                              for i in range(n_weights)]


def scene_extent(cfg: dict) -> float:
    """The scene's extent as the loop reads it (cameras_extent): 1.1 x
    the rig's radius."""
    return float(cfg["rig"]["radius"]) * 1.1


def mask_dir() -> str:
    """Where a FEATURE cell writes its views' mask files: a fixed path
    under the run's TMPDIR."""
    return os.path.join(os.environ.get("TMPDIR", "/tmp"), "port_bench_masks")


def build(torch, cfg: dict, traffic: dict, seed: int, dev):
    """The scene, views, ground truth and a Trainer on them."""
    from trase_tpu_torch.config import (ModelParams, OptimizationParams,
                                        PipelineParams)
    from trase_tpu_torch.data.cameras import Camera
    from trase_tpu_torch.engine import loop as L
    from trase_tpu_torch.engine import trainer as T
    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.ops.rasterize import RasterConfig

    params, alive = SG.make_gaussians(cfg["scene"], cfg["capacity"],
                                      cfg["n_alive"], cfg["sh_degree"],
                                      cfg["feature_dim"], seed, dev)
    weights = SG.make_deform_weights(cfg["deform"], seed, dev)
    views = SG.make_views(cfg, traffic)
    feature = traffic["regime"] == "feature"
    # a FEATURE step reads masks and no ground truth
    gt = [None] * len(views) if feature else SG.make_gt(
        len(views), cfg["image_height"], cfg["image_width"], seed,
        dev).cpu().numpy()
    mask_paths = (write_view_masks(cfg, views, seed, dev) if feature
                  else [None] * len(views))
    cams = [Camera(uid=i, colmap_id=i, R=v["R"], T=v["T"], fovx=v["fovx"],
                   fovy=v["fovy"], image=gt[i], image_name=v["name"],
                   image_path=None, image_width=v["width"],
                   image_height=v["height"], fid=v["fid"],
                   mask_path=mask_paths[i])
            for i, v in enumerate(views)]
    zeros = torch.zeros(cfg["capacity"], device=dev)
    aux = G.GaussianAux(alive=alive, max_radii2d=zeros,
                        xyz_gradient_accum=zeros.clone(), denom=zeros.clone())
    gp = G.GaussianParams(**params)
    scene = types.SimpleNamespace(
        gaussian_params=gp, gaussian_aux=aux, spatial_lr_scale=5.0,
        cameras_extent=scene_extent(cfg),
        get_train_cameras=lambda: cams, get_test_cameras=lambda: [])
    ds = ModelParams(sh_degree=cfg["sh_degree"], model_path="",
                     is_blender=False, is_6dof=False)
    opt = OptimizationParams(**cfg["recipe"])
    trainer = L.Trainer(ds, opt, PipelineParams(), scene, seed=seed,
                        device=dev, raster_cfg=RasterConfig(
                            pairs_per_gaussian=int(
                                traffic["pairs_per_gaussian"])))
    shapes = [tuple(t.shape) for t in trainer.state.deform]
    if shapes != [tuple(w.shape) for w in weights]:
        raise RuntimeError(f"the port's deform MLP has shapes {shapes}, the "
                           "configuration's differ")
    trainer.state = T.init_train_state(gp, aux, weights)
    for _ in range(int(traffic.get("table_doublings", 0))):
        # the table as the loop's capacity check grows it (Trainer._densify)
        st = trainer.state
        p, aux, o = G.grow_capacity(st.params, st.aux, st.opt,
                                    2 * st.params.xyz.shape[0])
        trainer.state = st._replace(params=p, aux=aux, opt=o)
        params, alive = p._asdict(), aux.alive
    trainer.active_sh_degree = cfg["sh_degree"]
    if feature:
        # a FEATURE block of the schedule, as a restored phase machine
        # holds it: the loop keeps the phase for the block's length
        trainer.opt_state.state = T.FEATURE
        trainer._phase_restored = True
    index = {id(c.to_render_camera(dev)): i for i, c in enumerate(cams)}
    return types.SimpleNamespace(trainer=trainer, T=T, params=params, dev=dev,
                                 alive=alive, weights=weights, views=views,
                                 cams=cams, index=index,
                                 regime=traffic["regime"],
                                 step_name="feature_phase_step" if feature
                                 else "gaussian_phase_step")


def write_view_masks(cfg: dict, views: list, seed: int, dev) -> list:
    """Each view's masks, made on the device from the seed, packed there
    and written as a mask file under mask_dir() (deflated on a few
    threads); returns the files' paths."""
    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(mask_dir(), ignore_errors=True)
    os.makedirs(mask_dir())
    H, W = cfg["image_height"], cfg["image_width"]
    shape = (cfg["masks"]["per_view"], H, W)
    paths = [os.path.join(mask_dir(), f"{v['name']}.npz") for v in views]
    with ThreadPoolExecutor(MASK_WRITERS) as pool:
        jobs = [pool.submit(SG.write_masks, path, SG.pack_masks(
            SG.make_masks(cfg["masks"], H, W, seed, i, dev)), shape)
            for i, path in enumerate(paths)]
        for job in jobs:
            job.result()
    return paths


def fill_caches(run):
    """Load the last views that the cache holds room for through the
    loop's own fetch path, one each and with no step: the GT cache, or the
    mask cache by way of the loop's prefetcher (each view's decode
    submitted while the one before it uploads)."""
    from trase_tpu_torch.engine import loop as L

    tr = run.trainer
    if run.regime != "feature":
        for cam in run.cams[-L.GT_CACHE_SIZE:]:
            tr._gt_image(cam)
        return
    tr._prepare_mask_meta(run.cams)
    cams = run.cams[-tr.mask_cache_size:]
    try:
        for i, cam in enumerate(cams):
            if i + 1 < len(cams):
                tr._submit_mask_prefetch(cams[i + 1])
            tr._masks_for(cam)
    finally:
        tr._close_prefetcher()


@contextlib.contextmanager
def cache_hits(run, hits: list):
    """Record in `hits`, for each fetch of a step's GT image or masks,
    whether the loop's cache already held it."""
    tr = run.trainer
    name = "_masks_for" if run.regime == "feature" else "_gt_image"
    cache = tr._mask_cache if run.regime == "feature" else tr._gt_cache
    fetch = getattr(tr, name)

    def fetched(cam):
        held = {id(v) for v in cache.values()}
        got = fetch(cam)
        hits.append(got is not None and id(got) in held)
        return got

    setattr(tr, name, fetched)
    try:
        yield
    finally:
        delattr(tr, name)


def call_inputs(run, args, kwargs) -> dict:
    """What the loop chose for one step call: the view, its time (and the
    GAUSSIAN step's time jitter), the pair budget, the SH degree and
    whether the deformation MLP is on."""
    c = {"view": run.index[id(args[1])],
         "K": int(kwargs["raster_cfg"].pairs_per_gaussian),
         "sh_degree": int(kwargs["sh_degree"]),
         "use_deform": bool(kwargs["use_deform"])}
    if run.regime == "feature":
        c.update(fid=float(args[4]), ast=0.0)
    else:
        c.update(fid=float(args[3]), ast=float(args[4]))
    return c


@contextlib.contextmanager
def recording(run, calls: list):
    """Record each step call's inputs in `calls`; in the FEATURE regime
    also the state of the generator the step draws its pixel and mask
    sample and its smoothing slots from, before it draws them."""
    T = run.T
    step_fn = getattr(T, run.step_name)

    def step(*args, **kwargs):
        c = call_inputs(run, args, kwargs)
        if run.regime == "feature":
            c["generator_state"] = kwargs["generator"].get_state().clone()
        calls.append(c)
        return step_fn(*args, **kwargs)

    setattr(T, run.step_name, step)
    try:
        yield
    finally:
        setattr(T, run.step_name, step_fn)


def trained(run, state) -> list:
    """The regime's trained leaves of a TrainState, in leaf_names' order,
    and their Adam first moments."""
    if run.regime == "feature":
        return ([state.params.gaussian_features],
                [state.opt.gaussian_features.mu])
    return ([getattr(state.params, k) for k in RS.FIELDS] + list(state.deform),
            [getattr(state.opt, k).mu for k in RS.FIELDS]
            + [s.mu for s in state.deform_opt])


def checked_steps(torch, run, first_iter: int):
    """Drive the trainer through its first CHECKED_STEPS steps by
    ``train``, its caches filled first; returns the calls' inputs, the
    program's readings (with the norms of its densification statistics
    after the last) and which steps found their view cached."""
    tr = run.trainer
    fill_caches(run)
    calls, losses, first, change, hits, stats = [], [], {}, {}, [], {}
    names = leaf_names(len(run.weights), run.regime)
    start = ([run.params["gaussian_features"]] if run.regime == "feature"
             else [run.params[k] for k in RS.FIELDS] + run.weights)

    def on_iteration(trainer, it, metrics):
        calls[-1]["iteration"] = it
        losses.append(metrics["loss"])
        leaves, moms = trained(run, trainer.state)
        if it == first_iter + 1:
            first.update({n: _norm(m) / 0.1 for n, m in zip(names, moms)})
        if it == first_iter + CHECKED_STEPS:
            change.update({n: _norm(a - b)
                           for n, a, b in zip(names, leaves, start)})
            stats.update({k: _norm(getattr(trainer.state.aux, k))
                          for k in RD.STATS})

    with recording(run, calls), cache_hits(run, hits):
        tr.opt.iterations = first_iter + CHECKED_STEPS
        tr.train(first_iter=first_iter, progress=False,
                 on_iteration=on_iteration)
    return {"calls": calls, "losses": [float(x) for x in losses],
            "first": first, "change": change, "stats": stats,
            "skipped": int(tr.skipped), "cache_hits": hits}


def host_state(state) -> dict:
    """A TrainState's gaussian table, statistics and Adam moments, copied
    to host memory, by field name."""
    return {"params": {k: v.cpu() for k, v in state.params._asdict().items()},
            "aux": {k: v.cpu() for k, v in state.aux._asdict().items()},
            "moments": {k: (s.mu.cpu(), s.nu.cpu())
                        for k, s in state.opt._asdict().items()}}


@contextlib.contextmanager
def densify_recording(run, record: dict, seen: list):
    """Record in `record` the first densification round of the block
    (``densify_step``, as the loop's ``_densify`` calls it): its iteration
    (the one after seen[0]), the state it started from and the one it
    returned, in host memory, and its split samples. The samples are drawn
    here from the round's own generator, in the shape the round draws, and
    handed to it: the generator gives the numbers it would have given
    inside the round."""
    import torch
    from trase_tpu_torch.models import gaussians as G

    T = run.T
    fn = T.densify_step

    def step(state, scene_extent, max_screen_size, *, cfg, max_new,
             generator=None, samples=None):
        if "after" in record:
            return fn(state, scene_extent, max_screen_size, cfg=cfg,
                      max_new=max_new, generator=generator, samples=samples)
        if samples is None:
            shape = G.split_sample_shape(state.params.xyz.shape[0], max_new,
                                         cfg)
            samples = torch.randn(shape, generator=generator,
                                  device=generator.device).to(
                                      state.params.xyz.device)
        record.update(iteration=seen[0] + 1, before=host_state(state),
                      samples=samples.cpu())
        new, stats = fn(state, scene_extent, max_screen_size, cfg=cfg,
                        max_new=max_new, generator=generator, samples=samples)
        record.update(after=host_state(new),
                      stats={k: int(v) for k, v in stats.items()})
        return new, stats

    T.densify_step = step
    try:
        yield
    finally:
        T.densify_step = fn


def warm_up(run, first_iter: int, iterations: int,
            densify: dict | None = None):
    """Iterations past the checked ones, the port's own pair-budget
    controller consulted after each (its checks otherwise come every 100
    iterations), so that K is settled before the window; with `densify`,
    the block's first densification round recorded in it."""
    tr = run.trainer
    seen = [first_iter]

    def settle(trainer, it, metrics):
        seen[0] = it
        trainer._handle_overflow(it, float(metrics["overflow"]),
                                 float(metrics["overflow_half"]))

    tr.opt.iterations = first_iter + iterations
    with (densify_recording(run, densify, seen) if densify is not None
          else contextlib.nullcontext()):
        tr.train(first_iter=first_iter, progress=False, on_iteration=settle)
    return first_iter + iterations


def window(torch, run, first_iter: int, seconds: float,
           last: int | None = None):
    """``train`` until `seconds` have passed, or through iteration `last`
    where that comes first; returns (iterations, seconds, per-iteration
    host intervals)."""
    tr = run.trainer
    stamps = []
    t0 = time.perf_counter()

    def on_iteration(trainer, it, metrics):
        now = time.perf_counter()
        stamps.append((it, now))
        if now - t0 >= seconds or it == last:
            raise _Stop

    tr.opt.iterations = 1 << 40
    try:
        tr.train(first_iter=first_iter, progress=False,
                 on_iteration=on_iteration)
    except _Stop:
        pass
    HB.sync(torch, run.dev)
    dt = time.perf_counter() - t0
    times = [t0] + [s for _, s in stamps]
    return len(stamps), dt, np.diff(times).tolist()


def stretch(torch, run, first_iter: int, n: int, trace_dir: str):
    """n iterations under the profiler; returns the profile and each
    call's inputs with the state it started from and its live rows."""
    tr = run.trainer
    st = tr.state
    state = {k: getattr(st.params, k).clone()
             for k in RS.FIELDS + ("gaussian_features",)}
    weights = [w.clone() for w in st.deform]
    alive = st.aux.alive.clone()
    calls = []

    def go():
        tr.opt.iterations = first_iter + n
        tr.train(first_iter=first_iter, progress=False)

    with recording(run, calls):
        prof = HB.profile_stretch(torch, go, trace_dir, run.dev)
    return prof, calls, state, weights, alive


def count_work(torch, cfg: dict, run, calls: list, state: dict, weights: list,
               alive):
    """The least time at the published peaks of each profiled step's
    compositor forward and backward, and the step's counted operations:
    GAUSSIAN composites rgb + depth (4 values) and differentiates it all;
    FEATURE composites the 32 features packed two to a word and
    differentiates the values alone, and adds the sampled pixels' gram
    and correspondence products; the deform MLP's where the step ran it."""
    dev = run.dev
    dcfg = cfg["deform"]
    H, W = cfg["image_height"], cfg["image_width"]
    tiles = -(-H // 16) * -(-W // 16)
    n_alive = int(alive.sum())
    in_dim = 3 * (1 + 2 * dcfg["multires"]) + 1 + 2 * dcfg["t_multires"]
    feature = run.regime == "feature"
    n_val = cfg["feature_dim"] if feature else 4
    words = 6 + n_val // 2 if feature else None
    passes = 1 if feature else 3  # the MLP: forward (and backward)
    fwd_ms, bwd_ms, bf16_flops, f32_flops = [], [], 0.0, 0.0
    with torch.no_grad():
        for c in calls:
            v = run.views[c["view"]]
            view = P.View(P.world_view_matrix(v["R"], v["T"]), v["fovx"],
                          v["fovy"], H, W, dev)
            n = state["xyz"].shape[0]
            deform = c.get("use_deform", True)
            d = (0.0, 0.0, 0.0)
            if deform:
                t = torch.full((n, 1), c["fid"], device=dev) + c["ast"]
                d = P.deform_mlp(weights, state["xyz"], t, dcfg["D"],
                                 dcfg["multires"], dcfg["t_multires"],
                                 hidden_dtype=torch.bfloat16)
            g = P.deformed_gaussians(state, alive, *d)
            proj = P.project(view, *g, sh_degree=c["sh_degree"])
            bins = P.bin_pairs(proj, H, W, c["K"])
            counts = {"evaluated": 0, "contributing": 0, "pairs": 0}
            P.composite(bins, *P.payload_of(proj), H, W, counts=counts)
            fb, fo = B.composite_fwd_work(counts, n_val, H, W, tiles, True,
                                          row_words=words)
            bb, bo = B.composite_bwd_work(counts, n_val, H, W, tiles, n,
                                          c["K"], row_words=words,
                                          values_only=feature)
            print(f"[port_bench] work of a profiled step: view {c['view']} "
                  f"K {c['K']} {counts} dropped {bins.dropped} valid "
                  f"{int(proj['valid'].sum())}", file=sys.stderr)
            fwd_ms.append(B.bound("", fb, fo)["bound_ms"])
            bwd_ms.append(B.bound("", bb, bo)["bound_ms"])
            if deform:
                bf16_flops += passes * 2 * n_alive * B.mlp_hidden_macs(in_dim)
            heads = passes * 2 * n_alive * 256 * 10 if deform else 0
            f32_flops += heads + fo + bo
            if feature:
                p_ = int(cfg["recipe"]["num_sampled_pixels"])
                f32_flops += 2.0 * p_ * p_ * (n_val + cfg["masks"]["per_view"])
            else:
                f32_flops += B.ssim_ops(H, W)
    k = max(len(calls), 1)
    return {"composite_fwd_bound_ms": fwd_ms, "composite_bwd_bound_ms": bwd_ms,
            "peak_s_per_step": (bf16_flops / B.BF16_FLOPS_PER_S
                                + f32_flops / B.F32_FLOPS_PER_S) / k}


def reference_readings(torch, cfg: dict, seed: int, prog: dict, dev,
                       dtype=None, fault: str | None = None,
                       with_stats: bool = False) -> dict:
    """Follow the program's first steps with the reference (regenerated
    inputs) and read the gaps; `with_stats`: the densification
    statistics' too."""
    ref = reference_run(torch, cfg, seed, prog["calls"], dev,
                        dtype or torch.float32, fault)
    got = compare(prog, ref)
    if with_stats:
        got["readings"]["densify_stats_gap"] = stats_gap(prog, ref)
    return got


def reference_run(torch, cfg: dict, seed: int, calls: list, dev, dtype,
                  fault=None) -> dict:
    """The reference's losses, first-gradient norms and change norms."""
    P.plain_precision()
    params, alive = SG.make_gaussians(cfg["scene"], cfg["capacity"],
                                      cfg["n_alive"], cfg["sh_degree"],
                                      cfg["feature_dim"], seed, dev)
    weights = SG.make_deform_weights(cfg["deform"], seed, dev)
    traffic = cfg["_traffic"]
    views = SG.make_views(cfg, traffic)
    H, W = cfg["image_height"], cfg["image_width"]
    feature = traffic["regime"] == "feature"
    steps = []
    for c in calls:
        v = views[c["view"]]
        step = dict(c, view=P.View(P.world_view_matrix(v["R"], v["T"]),
                                   v["fovx"], v["fovy"], H, W, dev))
        if feature:
            step["masks"] = SG.make_masks(cfg["masks"], H, W, seed,
                                          c["view"], dev)
            step["generator_state"] = c["generator_state"]
        else:
            step["gt"] = SG.make_gt(len(views), H, W, seed, dev,
                                    first=c["view"], count=1)[0]
        steps.append(step)
    names = leaf_names(len(weights), traffic["regime"])
    if feature:
        losses, g, f = RF.run_steps(params, alive, weights, steps,
                                    cfg["deform"], cfg["recipe"], dtype,
                                    fault)
        first, now, start = [g], [f], [params["gaussian_features"]]
    else:
        bg = torch.zeros(3, device=dev)
        losses, (gf, gw), (p, w), stats = RS.run_steps(
            params, alive, weights, steps, cfg["deform"], cfg["recipe"], bg,
            dtype, fault)
        first = [gf[k] for k in RS.FIELDS] + gw
        now = [p[k] for k in RS.FIELDS] + w
        start = [params[k] for k in RS.FIELDS] + weights
    out = {"losses": losses,
           "first": {n: _norm(g) for n, g in zip(names, first)},
           "change": {n: _norm(a - b) for n, a, b in zip(names, now, start)}}
    if not feature:
        out["stats"] = {k: _norm(v) for k, v in stats.items()}
    return out


def stats_gap(prog: dict, ref: dict) -> float:
    """densify_stats_gap: by the worst of the three statistics after the
    checked steps, |norm of the program's - the reference's| over the
    reference's."""
    if not prog.get("stats") or not ref.get("stats"):
        return math.inf
    return max(abs(prog["stats"][k] - ref["stats"][k])
               / max(ref["stats"][k], 1e-30) for k in RD.STATS)


def densify_inputs(cfg: dict, traffic: dict, record: dict) -> dict:
    """The recorded round's settings: the recipe's thresholds, the
    method's constants and the loop's budget as the traffic states them,
    and the screen-size limit from the first opacity reset on."""
    recipe, d = cfg["recipe"], traffic["densify"]
    after_reset = record["iteration"] > recipe["opacity_reset_interval"]
    return {"extent": scene_extent(cfg),
            "max_screen_size": float(d["size_threshold"]) if after_reset
            else 0.0,
            "grad_threshold": float(recipe["densify_grad_threshold"]),
            "percent_dense": float(recipe["percent_dense"]),
            "min_opacity": float(d["min_opacity"]),
            "split_n": int(d["split_n"]), "max_new": int(d["max_new"])}


def on_device(tree, dev):
    """A recorded state (nested dicts and tuples of tensors) on `dev`."""
    if isinstance(tree, dict):
        return {k: on_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(on_device(v, dev) for v in tree)
    return tree.to(dev)


def plain_round(torch, cfg: dict, traffic: dict, record: dict, dev,
                dtype=None, fault: str | None = None) -> dict:
    """The reference's round on the recorded input and samples; `dtype`
    its arithmetic's precision (the control), `fault` one planted in it:
    ``threshold_halved`` (the gradient threshold halved) or
    ``prune_skipped`` (nothing pruned)."""
    kw = densify_inputs(cfg, traffic, record)
    if fault == "threshold_halved":
        kw["grad_threshold"] /= 2.0
    elif fault == "prune_skipped":
        kw.update(min_opacity=0.0, max_screen_size=0.0)
    before = on_device(record["before"], dev)
    return RD.densify_round(before["params"], before["aux"],
                            before["moments"],
                            samples=record["samples"].to(dev),
                            dtype=dtype or torch.float32, **kw)


def densify_readings(torch, cfg: dict, traffic: dict, record: dict,
                     dev) -> dict:
    """The recorded round against the reference's: densify_rows_gap and
    densify_gap (inf where no round was recorded)."""
    if "after" not in record:
        return {"readings": {"densify_rows_gap": math.inf,
                             "densify_gap": math.inf},
                "detail": {"round": "none recorded in the warm-up"}}
    ref = plain_round(torch, cfg, traffic, record, dev)
    got = RD.compare(on_device(record["after"], dev), ref,
                     on_device(record["before"], dev))
    return {"readings": got["readings"],
            "detail": {"iteration": record["iteration"],
                       "rows": int(record["before"]["aux"]["alive"].shape[0]),
                       "reference": ref["counts"],
                       "program": record["stats"],
                       "worst": got["worst"]}}


def compare(prog: dict, ref: dict) -> dict:
    """The check's numbers: the first step's relative loss gap (the later
    steps' losses carry the noise of Adam's first, sign-like updates of
    leaves whose gradients are rounding: a detail, not compared), and by
    the worst leaf the first-gradient and the change gaps; leaves whose
    reference gradient is under a thousandth of the median leaf's are
    left out."""
    med = float(np.median(list(ref["first"].values())))
    skip = [k for k, v in ref["first"].items() if v < 1e-3 * med]
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    loss_gap = gaps[0] if gaps else math.inf
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    grad_gap, grad_leaf = HB.gap_by_worst_leaf(prog["first"], ref["first"],
                                               skip)
    change_gap, change_leaf = HB.gap_by_worst_leaf(prog["change"],
                                                   ref["change"], skip)
    return {"readings": {"loss_gap": loss_gap, "first_grad_gap": grad_gap,
                         "change_gap": change_gap},
            "worst": {"first_grad_gap": grad_leaf, "change_gap": change_leaf,
                      "loss_gap_by_step": gaps},
            "skipped_leaves": skip}


@contextlib.contextmanager
def kept_rounds(tr, rounds: list):
    """Keep each densification round's iteration and counts in `rounds`
    (the counts stay on the device until they are read)."""
    fn = tr._densify

    def densify(iteration):
        stats = fn(iteration)
        rounds.append((iteration, stats))
        return stats

    tr._densify = densify
    try:
        yield
    finally:
        del tr._densify


def round_counts(rounds: list) -> list:
    """[iteration, clones, splits, pruned, live rows after] a round."""
    return [[i] + [int(s[k]) for k in ("n_clone", "n_split", "n_pruned",
                                        "n_alive")] for i, s in rounds]


def schedule(recipe: dict, start: int, end: int) -> dict:
    """The densification rounds and opacity resets the loop's schedule
    puts after iteration `start`, up to `end` (train.py:361-373)."""
    its = range(start + 1, end + 1)
    until = recipe["densify_until_iter"]
    return {"densify_rounds": sum(
        1 for i in its if recipe["densify_from_iter"] < i < until
        and i % recipe["densification_interval"] == 0),
        "opacity_resets": [i for i in its if i < until
                           and i % recipe["opacity_reset_interval"] == 0]}


def run(torch, ctx) -> dict:
    """One run of a training cell; returns the result and the check."""
    cfg, traffic, args = ctx.cfg, ctx.traffic, ctx.args
    first_iter = int(traffic["first_iteration"])
    marks, memory = [time.perf_counter()], []

    def mark():
        HB.sync(torch, ctx.device)
        marks.append(time.perf_counter())
        memory.append(HB.memory_gb(torch, ctx.device))

    limits = ctx.workload["limits"]
    record = {} if "densify_rows_gap" in limits else None
    run_ = build(torch, cfg, traffic, args.seed, ctx.device)
    mark()
    prog = checked_steps(torch, run_, first_iter)
    mark()
    it = first_iter + CHECKED_STEPS
    run_.params = run_.weights = None
    # the pair budget settles, and the caches turn over as in a long run
    it = warm_up(run_, it, int(traffic.get("warm_up_iterations",
                                           len(run_.views))), record)
    mark()
    setup_s = marks[-1] - ctx.t_start
    print("[port_bench] set-up: start {:.3f}, build {:.3f}, caches and "
          "checked steps {:.3f}, warm-up {:.3f} s; device GB (held, peak) "
          "after each: {}".format(marks[0] - ctx.t_start, *np.diff(marks),
                                  memory), file=sys.stderr)
    tr = run_.trainer
    n_traced = int(traffic["traced_iterations"])
    before = bool(traffic.get("profile_before_window", False))
    if args.trace and before:
        prof, calls, state, weights, alive = stretch(torch, run_, it,
                                                     n_traced, ctx.trace_dir)
        it += n_traced
    skipped0 = int(tr.skipped)

    spans, rounds = HB.Spans(), []
    capacity0 = tr.state.params.xyz.shape[0]
    with kept_rounds(tr, rounds):
        if args.trace:
            spans.wrap(run_.T, run_.step_name, "step")
            spans.wrap(tr, "_densify", "densify")
        n_it, dt, intervals = window(torch, run_, it, args.seconds,
                                     traffic.get("last_iteration"))
        spans.restore()
    HB.report_rates(np.cumsum(intervals), dt, "iterations")
    failed = int(tr.skipped) - skipped0
    in_window = schedule(cfg["recipe"], it, it + n_it)
    in_window.update(last_iteration=it + n_it,
                     capacity=[capacity0, tr.state.params.xyz.shape[0]],
                     alive_at_end=int(tr.state.aux.alive.sum()),
                     rounds=round_counts(rounds))
    print(f"[port_bench] in the window: {in_window}", file=sys.stderr)
    it += n_it
    measure = None
    if args.trace and not before:
        prof, calls, state, weights, alive = stretch(torch, run_, it,
                                                     n_traced, ctx.trace_dir)
    device = HB.device_record(torch, ctx.device)
    print(f"[port_bench] device GB (held, peak) after the window: "
          f"{HB.memory_gb(torch, ctx.device)}", file=sys.stderr)
    if args.trace:
        reading = HB.read_profile(prof)
        for n, ds in reading["launches"].items():
            if "composite" in n or "reduce_pair" in n or "reduce_slab" in n:
                print(f"[port_bench] launches of {n[:60]}: "
                      f"{[round(d * 1e3, 4) for d in ds]} ms",
                      file=sys.stderr)
        work = count_work(torch, cfg, run_, calls, state, weights, alive)
        measure = {"iteration_s": intervals,
                   "step_s": spans.durations.get("step", []),
                   "densify_s": spans.durations.get("densify", []),
                   "window_iterations": n_it, "window_s": dt,
                   "profile": reading, "work": work,
                   "stretch_iterations": len(calls)}
        device.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        del state, weights, alive, calls
    del run_, tr
    shutil.rmtree(mask_dir(), ignore_errors=True)
    gc.collect()
    HB.free(torch, ctx.device)

    cfg = dict(cfg, _traffic=traffic)
    t_check = time.perf_counter()
    got = reference_readings(torch, cfg, args.seed, prog, ctx.device,
                             with_stats="densify_stats_gap" in limits)
    if record is not None:
        rounds = densify_readings(torch, cfg, traffic, record, ctx.device)
        got["readings"].update(rounds["readings"])
        got["worst"]["densify"] = rounds["detail"]
        del record
    HB.sync(torch, ctx.device)
    if prog["skipped"]:
        got["readings"]["loss_gap"] = math.inf
    result = {"attempted": n_it, "failed": failed, "device": device,
              "setup_s": setup_s, "check_s": time.perf_counter() - t_check,
              "end_to_end": {"train_it_s": n_it / dt, "setup_s": setup_s},
              "measure": measure, "readings": got["readings"],
              "detail": {"worst_leaf": got["worst"],
                         "skipped_leaves": got["skipped_leaves"],
                         "program_losses": prog["losses"],
                         "checked_cache_hits": prog["cache_hits"],
                         "K": [c["K"] for c in prog["calls"]],
                         "window": in_window}}
    if measure is not None:
        result["breakdown"] = {"device_ops": reading["device_ops"],
                               "idle_gaps": reading["idle_gaps"]}
    return result
