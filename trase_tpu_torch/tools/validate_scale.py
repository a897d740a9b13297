"""Production-scale end-to-end validation of the port.

    python -m trase_tpu_torch.tools.validate_scale --out DIR [flags]

Counterpart of tools/validate_scale.py, with the same flags and defaults
plus ``--device`` and ``--score_only``. It writes a synthetic dynamic
scene (1008 px by default; ``--n_times`` > 0 gives the Neu3D-style rig of
n_train // n_times cameras x n_times timestamps with a held-out test
camera), trains both phases through densification (``Trainer``, or with
``--mesh N`` a ``ShardedTrainer`` over N ranks), and at each of
``--milestones`` and at the end runs the whole evaluation: the test PSNR
of ``Trainer.evaluate``, a snapshot, HDBSCAN clustering of its features
(``python -m trase_tpu_torch.cluster``), clusters matched to the scene's
objects by intersection over area on the first test view, each object's
rendered mask on every test view, and their mIoU. Each evaluation
appends one JSON line to ``<out>/curve.jsonl`` as soon as it is done; the
last line of standard output is the result, with the keys of the root
tool's.

HDBSCAN needs scikit-learn. Where it is not installed, an evaluation does
not guess: its line has ``"miou": null, "n_clusters": null, "scored":
false`` and the snapshot stays on disk. ``--score_only`` then scores every
milestone snapshot under ``<out>/model`` wherever scikit-learn is
installed (``--device cpu`` or ``cuda``), appending one line per snapshot
to ``<out>/curve_scored.jsonl``; a ``clusters.pt`` already saved beside a
snapshot is used as it is, so the clustering can run on one machine and
the masks be rendered on another.

Failure semantics: ``--max_hours`` ends training at the deadline, runs the
final evaluation and exits normally with ``"aborted": true``. A training
step that raises gets the same salvage evaluation, then the exception is
raised again, so a run that died exits non-zero (the root tool exits 0).
In a world of ranks (``--mesh``) the exception is raised at once: a rank
that died leaves the others' collectives waiting. ``--stall_timeout_s``
arms the loop's stall watchdog (exit code 86).

Usage (one card, a few minutes):
    python -m trase_tpu_torch.tools.validate_scale --out /tmp/scale_val
The 30k-iteration multi-view schedule:
    python -m trase_tpu_torch.tools.validate_scale --out /tmp/scale_30k \\
        --image_size 1008 --n_train 60 --n_test 6 --n_times 6 \\
        --iterations 30000 --feature_warmup_frac 0.5 \\
        --milestones 3000,8000,15000,20000,25000,30000 \\
        --target_alive 0 --densify_until_frac 0.08
CPU smoke, both phases (FEATURE from iteration 102: the phase machine
switches after 100 counted steps; the FEATURE step samples 5000 pixels,
so the views need at least that many):
    python -m trase_tpu_torch.tools.validate_scale --out /tmp/scale_smoke \\
        --device cpu --image_size 72 --iterations 110 --pts_per_blob 32 \\
        --n_train 6 --n_test 2 --max_new 512 --target_alive 0 \\
        --feature_warmup_frac 0.5 --milestones 60
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import time
import uuid

import numpy as np
import torch

# the masks' objects: a cluster must cover this many pixels of the first
# test view to be matched, and that share of its pixels must lie in one
# object's mask (tools/validate_scale.py:137-144)
MIN_MATCH_AREA, MIN_IOA = 16, 0.5


class _Deadline(Exception):
    """Raised from the iteration hook when --max_hours is exceeded."""


def sklearn_available() -> bool:
    """Whether HDBSCAN (scikit-learn) can run here."""
    return importlib.util.find_spec("sklearn") is not None


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    device's name where there is no card."""
    if torch.device(device).type != "cuda":
        return str(device)
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def _snapshot_dir(model_dir: str, iteration: int) -> str:
    return os.path.join(model_dir, "point_cloud", f"iteration_{iteration}")


def cluster_snapshot(model_dir: str, iteration: int, n_alive: int,
                     device, sample_percent=None) -> np.ndarray:
    """HDBSCAN of the snapshot's features through the cluster CLI (a 2 %
    sample above 100k gaussians, all of them below, as the root tool
    chooses); returns the cluster id of each snapshot row."""
    from ..cluster.__main__ import main as cluster_main
    from ..cluster.clustering import load_clusters

    if sample_percent is None:
        sample_percent = 0.02 if n_alive > 100_000 else 1.0
    cluster_main(["-m", model_dir, "--iteration", str(iteration),
                  "--sample_percent", str(sample_percent),
                  "--device", torch.device(device).type])
    ids, _ = load_clusters(os.path.join(_snapshot_dir(model_dir, iteration),
                                        "clusters.pt"))
    return ids


def _gt_masks(cam) -> np.ndarray:
    """(objects, H, W) bool masks of a camera."""
    from ..data.masks import decode_mask_file

    masks = cam.masks if cam.masks is not None else decode_mask_file(
        cam.mask_path)
    return np.asarray(masks) > 0


@torch.no_grad()
def mask_miou(params, alive, deform_net, deform, cluster_of, test_cams,
              raster_cfg, device, is_6dof=False) -> float:
    """mIoU of the clusters' rendered object masks (tools/validate_scale.py:
    99-168; reference render.py:334-366, metrics_segmentation.py:40-48).

    `cluster_of`: (capacity,) cluster id of each slot, -1 for dead ones.
    Clusters are matched to the objects on the first test view: a cluster
    whose mask covers at least MIN_MATCH_AREA pixels goes to the object
    holding the largest share of it, when that share exceeds MIN_IOA.
    Each object's mask on every test view is the render, with only its
    clusters' gaussians kept, binarized at alpha > 0.5; an object no
    cluster matched scores 0. The deformation at a view's time is computed
    once and reused for every cluster (the masks read alpha alone, which
    the SH degree does not change: they render at degree 0)."""
    from ..engine import trainer as T
    from ..renderer import render

    bg = torch.zeros(3, device=device)
    deltas = {}

    def render_mask(vi, cam, member):
        if vi not in deltas:
            deltas[vi] = T.apply_deform(deform_net, deform, params.xyz,
                                        cam.fid, 0.0, True,
                                        params.gaussian_features)
        keep = torch.as_tensor(member, device=device)
        out = render(cam.to_render_camera(device), params, alive, bg,
                     *deltas[vi], is_6dof=is_6dof, sh_degree=0,
                     with_features=False, mask=keep, raster_cfg=raster_cfg)
        return (out["alpha"][0] > 0.5).cpu().numpy()

    gt0 = _gt_masks(test_cams[0])
    n_objects = gt0.shape[0]
    owners = [[] for _ in range(n_objects)]
    for c in range(int(cluster_of.max()) + 1):
        member = cluster_of == c
        if not member.any():
            continue
        m = render_mask(0, test_cams[0], member)
        area = m.sum()
        if area < MIN_MATCH_AREA:
            continue
        ioa = [(m & gt0[b]).sum() / area for b in range(n_objects)]
        b = int(np.argmax(ioa))
        if ioa[b] > MIN_IOA:
            owners[b].append(c)

    ious = []
    for vi, cam in enumerate(test_cams):
        gt = _gt_masks(cam)
        for b in range(n_objects):
            if not owners[b]:
                ious.append(0.0)
                continue
            pred = render_mask(vi, cam, np.isin(cluster_of, owners[b]))
            inter = (pred & gt[b]).sum()
            union = (pred | gt[b]).sum()
            ious.append(float(inter) / max(float(union), 1.0))
    return float(np.mean(ious)) if ious else 0.0


def _on(tree, device):
    """A NamedTuple of tensors (or a list of them) on `device`."""
    if isinstance(tree, list):
        return [t.to(device) for t in tree]
    return type(tree)(*(t.to(device) for t in tree))


def seg_eval(trainer, scene, dataset, raster_cfg, model_dir, iteration,
             sample_percent=None):
    """The segmentation score of the trainer's current state
    (tools/validate_scale.py: seg_eval): saves the snapshot at `iteration`
    (its rows are the live state's), clusters it, and scores the clusters'
    masks on the test views (mask_miou). Returns (miou, n_clusters,
    n_alive); miou and n_clusters are None where scikit-learn is missing.

    `trainer.state` must be the whole state: a ShardedTrainer calls this
    inside `_on_rank0_with_global`."""
    from ..engine.loop import Trainer

    state = trainer.state
    alive = state.aux.alive
    n_alive = int(alive.sum())
    # the single-device save: a sharded trainer's state is the gathered
    # one here, on rank 0 alone
    Trainer.save_snapshot(trainer, iteration)
    stale = os.path.join(_snapshot_dir(model_dir, iteration), "clusters.pt")
    if os.path.exists(stale):
        os.remove(stale)
    if not sklearn_available():
        print(f"[validate_scale] iter {iteration}: scikit-learn is not "
              "installed: the snapshot is kept for --score_only")
        return None, None, n_alive
    dev = trainer.device
    ids = cluster_snapshot(model_dir, iteration, n_alive, dev,
                           sample_percent)
    n_clusters = int(ids.max()) + 1
    print(f"[validate_scale] iter {iteration}: {n_clusters} clusters "
          f"over {n_alive} alive")
    alive_idx = np.flatnonzero(alive.cpu().numpy())
    assert len(ids) == len(alive_idx), (len(ids), len(alive_idx))
    cluster_of = np.full(alive.shape[0], -1, np.int64)
    cluster_of[alive_idx] = ids
    miou = mask_miou(_on(state.params, dev), alive.to(dev),
                     trainer.deform_net, _on(state.deform, dev), cluster_of,
                     scene.get_test_cameras(), raster_cfg, dev,
                     is_6dof=dataset.is_6dof)
    return miou, n_clusters, n_alive


def score_snapshot(model_dir: str, iteration: int, scene, dataset,
                   raster_cfg, device, sample_percent=None):
    """seg_eval of a saved snapshot: point_cloud/iteration_N/point_cloud.ply
    and deform/iteration_N/deform.pkl through the port's loaders; a
    clusters.pt beside the ply is used as it is, else the snapshot is
    clustered. Returns (miou, n_clusters, n_alive)."""
    from ..cluster.clustering import load_clusters
    from ..models.deform import load_flax_params, make_deform_network
    from ..models.gaussians_io import load_checkpoint, load_gaussian_ply
    from ..engine import trainer as T

    snap = _snapshot_dir(model_dir, iteration)
    params, aux, n, _ = load_gaussian_ply(
        os.path.join(snap, "point_cloud.ply"), sh_degree=dataset.sh_degree,
        device=device)
    saved = load_checkpoint(os.path.join(model_dir, "deform",
                                         f"iteration_{iteration}",
                                         "deform.pkl"))
    net = make_deform_network(saved.get("type", "DeformNetwork"),
                              is_blender=dataset.is_blender,
                              is_6dof=dataset.is_6dof, device=device)
    load_flax_params(net, saved["vars"])
    path = os.path.join(snap, "clusters.pt")
    if os.path.exists(path):
        ids, _ = load_clusters(path)
    else:
        ids = cluster_snapshot(model_dir, iteration, n, device,
                               sample_percent)
    if len(ids) != n:
        raise ValueError(f"{path}: {len(ids)} cluster ids for {n} gaussians")
    cluster_of = np.full(params.xyz.shape[0], -1, np.int64)
    cluster_of[:n] = ids
    miou = mask_miou(params, aux.alive, net, T.deform_tensors(net),
                     cluster_of, scene.get_test_cameras(), raster_cfg,
                     device, is_6dof=dataset.is_6dof)
    return miou, int(ids.max()) + 1, n


def make_parser() -> argparse.ArgumentParser:
    """tools/validate_scale.py's flags and defaults (:173-219), plus
    --device and --score_only."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="working dir (dataset + model are written here)")
    ap.add_argument("--image_size", type=int, default=1008)
    ap.add_argument("--n_blobs", type=int, default=5)
    ap.add_argument("--pts_per_blob", type=int, default=2400)
    ap.add_argument("--n_train", type=int, default=24)
    ap.add_argument("--n_test", type=int, default=4)
    ap.add_argument("--n_times", type=int, default=0,
                    help="0 = monocular ring (time==angle); >0 = "
                         "Neu3D-style rig: n_train//n_times cameras x "
                         "n_times timestamps, test cameras held out "
                         "(novel-view PSNR then measures "
                         "reconstruction, not monocular ambiguity)")
    ap.add_argument("--iterations", type=int, default=3000)
    ap.add_argument("--target_alive", type=int, default=300_000,
                    help="densify until at least this many alive "
                         "gaussians (0 = just run the schedule)")
    ap.add_argument("--pairs_per_gaussian", type=int, default=8)
    # the root tool's per-tile capacity, accepted: the tiled compositor
    # bins every pair, so the value goes nowhere
    ap.add_argument("--max_per_tile", type=int, default=1024)
    ap.add_argument("--pack_features", action="store_true",
                    help="bf16-paired feature payload (quality "
                         "validation of RasterConfig.pack_features)")
    ap.add_argument("--max_new", type=int, default=32768,
                    help="per-densify growth budget")
    ap.add_argument("--feature_warmup_frac", type=float, default=0.6,
                    help="fraction of the schedule before the FEATURE "
                         "phase starts (reference: 15k/30k = 0.5, "
                         "arguments/__init__.py:94-134)")
    ap.add_argument("--densify_until_frac", type=float, default=0.55)
    ap.add_argument("--milestones", type=str, default="",
                    help="CSV of iterations at which to run the full "
                         "PSNR+cluster+mIoU eval; each appends one line "
                         "to <out>/curve.jsonl immediately")
    ap.add_argument("--max_hours", type=float, default=0.0,
                    help="abort training gracefully past this wall "
                         "clock (>0); the last completed milestone "
                         "still stands and a final eval runs")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the trainer over an N-device mesh")
    ap.add_argument("--stall_timeout_s", type=float, default=1800.0,
                    help="hard-exit (rc 86) when no iteration "
                         "completes for this long: a hung kernel or "
                         "collective blocks the host where --max_hours "
                         "can never fire (0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--score_only", action="store_true",
                    help="score every milestone snapshot under <out>/model "
                         "(needs scikit-learn unless clusters.pt is saved "
                         "beside it) into <out>/curve_scored.jsonl; no "
                         "training")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check a command line (argparse's error, exit 2, for a
    --mesh the device count cannot seat, or --mesh with --score_only)."""
    ap = make_parser()
    args = ap.parse_args(argv)
    if args.mesh < 0:
        ap.error("--mesh must be >= 0")
    if args.mesh and args.score_only:
        ap.error("--score_only runs on one device: drop --mesh")
    if args.mesh > 0 and torch.device(args.device).type == "cuda":
        from ..parallel.world import check_devices

        try:
            check_devices(args.mesh)
        except RuntimeError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    return args


def _dataset_args(out_dir: str):
    from ..config import ModelParams

    return ModelParams(source_path=os.path.join(out_dir, "data"),
                       model_path=os.path.join(out_dir, "model"), eval=True,
                       is_blender=True)


def _scene(dataset, device, load_iteration=None):
    from ..data.scene import Scene

    # the camera shuffle draws from python's random: seeded, so a run's
    # test views come in the same order every time
    random.seed(0)
    return Scene(dataset, load_iteration=load_iteration,
                 resolution_scales=(1.0,), device=device)


def _raster_cfg(args):
    from ..ops.rasterize import RasterConfig

    return RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian,
                        pack_features=args.pack_features)


def write_dataset(args, data_dir: str, device) -> float:
    """The synthetic scene, written once into data_dir on `device` (the GT
    through the tiled compositor above 256 px); returns the seconds it
    took (0 when it was there)."""
    from ..data.synthetic import write_synthetic_dataset

    if os.path.exists(os.path.join(data_dir, "transforms_train.json")):
        return 0.0
    print(f"[validate_scale] writing {args.image_size}px dataset "
          f"({args.n_blobs} blobs x {args.pts_per_blob} pts)...", flush=True)
    t0 = time.perf_counter()
    write_synthetic_dataset(
        data_dir, n_train=args.n_train, n_test=args.n_test,
        image_size=args.image_size, n_blobs=args.n_blobs,
        pts_per_blob=args.pts_per_blob, seed=args.seed,
        fast_gt=args.image_size > 256, n_times=args.n_times, device=device)
    return time.perf_counter() - t0


def run(args, world=None, on_iteration=None):
    """Write the dataset, train, evaluate at the milestones and at the end;
    returns the result dict (None on ranks other than 0). `on_iteration`,
    when given, is called after the tool's own hook each iteration, as
    (trainer, iteration, metrics)."""
    from ..config import OptimizationParams, PipelineParams
    from ..engine.loop import Trainer
    from .. import resolve_device

    out_dir = os.path.abspath(args.out)
    dataset = _dataset_args(out_dir)
    model_dir = dataset.model_path
    lead = world is None or world.rank == 0
    device = resolve_device(args.device) if world is None else world.device
    t_data = write_dataset(args, dataset.source_path, device) if lead else 0.0
    if world is not None:
        import torch.distributed as dist

        dist.barrier(group=world.group)

    opt = OptimizationParams(
        iterations=args.iterations,
        warm_up=min(300, args.iterations // 10),
        warm_up_3d_features=int(args.iterations * args.feature_warmup_frac),
        iterative_opt_interval=100,
        densify_from_iter=50,
        densify_until_iter=int(args.iterations * args.densify_until_frac),
        densification_interval=100,
        densify_grad_threshold=1e-4,  # aggressive: drive N to the target
        opacity_reset_interval=100_000,  # keep everything contributing
        position_lr_max_steps=args.iterations,
        deform_lr_max_steps=args.iterations,
    )
    raster_cfg = _raster_cfg(args)
    # a world builds the global state on the host (ShardedTrainer)
    scene = _scene(dataset, device if world is None else "cpu")
    if world is None:
        trainer = Trainer(dataset, opt, PipelineParams(), scene,
                          raster_cfg=raster_cfg,
                          max_new_per_densify=args.max_new, seed=args.seed,
                          device=device)
    else:
        from ..parallel.trainer import ShardedTrainer

        trainer = ShardedTrainer(dataset, opt, PipelineParams(), scene, world,
                                 raster_cfg=raster_cfg,
                                 max_new_per_densify=args.max_new,
                                 seed=args.seed)

    milestones = sorted(int(m) for m in args.milestones.split(",") if m)
    curve_path = os.path.join(out_dir, "curve.jsonl")
    alive_track = []
    deadline = (time.perf_counter() + args.max_hours * 3600.0
                if args.max_hours > 0 else None)
    t1 = time.perf_counter()
    evaluated = {"iteration": None, "entry": None}

    def milestone_eval(iteration):
        psnr = trainer.evaluate(iteration)  # every rank renders its block
        box = {}

        def score():
            box["seg"] = seg_eval(trainer, scene, dataset, raster_cfg,
                                  model_dir, iteration)

        if world is None:
            score()
        else:
            trainer._on_rank0_with_global(score)
        evaluated["iteration"] = iteration
        if not lead:
            return
        miou, n_clusters, n_alive = box["seg"]
        entry = {
            "iteration": iteration,
            "n_alive": n_alive,
            "psnr_test": psnr,
            "miou": miou,
            "n_clusters": n_clusters,
            "elapsed_s": time.perf_counter() - t1,
            "scored": miou is not None,
        }
        with open(curve_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        print(f"[validate_scale] milestone {json.dumps(entry)}", flush=True)
        evaluated["entry"] = entry

    def past_deadline(iteration) -> bool:
        if deadline is None:
            return False
        late = time.perf_counter() > deadline
        if world is None:
            return late
        if iteration % 10:
            return False
        # the ranks stop at the same iteration: rank clocks differ
        from ..parallel.world import all_reduce

        flag = torch.tensor([float(late)], device=world.device)
        return bool(all_reduce(flag, world, op=torch.distributed.ReduceOp.MAX))

    last_seen = [0]
    extra_hook = on_iteration

    def on_iteration(tr, iteration, metrics):
        last_seen[0] = iteration
        if iteration % 200 == 0:
            n_alive = tr._num_alive()
            alive_track.append((iteration, n_alive))
            print(f"  iter {iteration}: loss {float(metrics['loss']):.4f} "
                  f"alive {n_alive}", flush=True)
        # keep densifying (past the schedule's until_iter) while under the
        # alive target, the way a user would retune the schedule
        if (args.target_alive and iteration < args.iterations * 0.8
                and iteration % opt.densification_interval == 0
                and iteration > opt.densify_until_iter
                and tr._num_alive() < args.target_alive):
            tr._densify(iteration)
        if iteration in milestones and iteration < args.iterations:
            milestone_eval(iteration)
        if extra_hook is not None:
            extra_hook(tr, iteration, metrics)
        if past_deadline(iteration):
            raise _Deadline(iteration)

    aborted_at, died = None, None
    try:
        trainer.train(first_iter=0, saving_iterations=set(),
                      testing_iterations=set(), progress=lead,
                      on_iteration=on_iteration,
                      stall_timeout_s=args.stall_timeout_s)
    except _Deadline as e:
        aborted_at = int(e.args[0])
        print(f"[validate_scale] --max_hours hit at iter {aborted_at}; "
              f"running final eval on the current state")
    except Exception as e:  # salvage the curve, then raise it again
        if world is not None:
            raise
        aborted_at, died = max(last_seen[0], 1), e
        print(f"[validate_scale] training DIED at iter ~{aborted_at} "
              f"({type(e).__name__}: {e}); final eval on the last "
              f"state, then the error is raised again")
    t_train = time.perf_counter() - t1

    final_iter = aborted_at if aborted_at is not None else args.iterations
    if evaluated["iteration"] != final_iter:
        milestone_eval(final_iter)
    if not lead:
        if died is not None:
            raise died
        return None
    last = evaluated["entry"]
    result = {
        "metric": "scale_validation",
        "image_size": args.image_size,
        "iterations": final_iter,
        "aborted": aborted_at is not None,
        "n_alive": last["n_alive"],
        "psnr_test": last["psnr_test"],
        "miou": last["miou"],
        "n_clusters": last["n_clusters"],
        "train_s": t_train,
        "iters_per_s": final_iter / t_train,
        "data_gen_s": t_data,
        "alive_track": alive_track[-5:],
        "pack_features": bool(args.pack_features),
    }
    if died is not None:
        print(json.dumps(result), flush=True)
        raise died
    return result


def score_only(args) -> list:
    """--score_only: score every milestone snapshot under <out>/model into
    <out>/curve_scored.jsonl; returns the lines."""
    from .. import resolve_device

    out_dir = os.path.abspath(args.out)
    dataset = _dataset_args(out_dir)
    device = resolve_device(args.device)
    pc_dir = os.path.join(dataset.model_path, "point_cloud")
    iterations = sorted(int(d.split("_")[-1]) for d in os.listdir(pc_dir)
                        if d.startswith("iteration_"))
    scene = _scene(dataset, device, load_iteration=iterations[-1])
    lines = []
    path = os.path.join(out_dir, "curve_scored.jsonl")
    for it in iterations:
        t0 = time.perf_counter()
        miou, n_clusters, n_alive = score_snapshot(
            dataset.model_path, it, scene, dataset, _raster_cfg(args), device)
        entry = {"iteration": it, "n_alive": n_alive, "miou": miou,
                 "n_clusters": n_clusters, "scored": True,
                 "score_s": time.perf_counter() - t0}
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        print(f"[validate_scale] scored {json.dumps(entry)}", flush=True)
        lines.append(entry)
    return lines


def _worker(rank, args, store_dir):
    """One rank of a --mesh run: join the world (a file store in
    store_dir, or torchrun's environment), run, leave. Rank 0 writes the
    result to <out>/result.json for the spawning process; the other ranks
    print nothing."""
    from ..parallel.world import close_world, init_world

    if rank:
        sys.stdout = open(os.devnull, "w")
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.mesh))
    world = init_world(args.mesh, rank, args.device, store_dir=store_dir)
    try:
        result = run(args, world)
    finally:
        close_world()
    if rank == 0 and store_dir is not None:
        with open(os.path.join(os.path.abspath(args.out), "result.json"),
                  "w") as f:
            json.dump(result, f)
    return result


def main(argv=None):
    """Parse, then train and evaluate (one device, or --mesh N ranks:
    spawned here, or this process's rank of torchrun's world), or with
    --score_only score the saved snapshots. Prints the card's line, then
    the result as the last line; returns the result (the scored lines
    with --score_only; under torchrun None on ranks other than 0)."""
    args = parse_args(argv)
    print(f"[validate_scale] device: {card_line(args.device)}", flush=True)
    if args.score_only:
        return score_only(args)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    if args.mesh == 0:
        result = run(args)
    elif "WORLD_SIZE" in os.environ:
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if size != args.mesh:
            raise SystemExit(f"--mesh {args.mesh} under a torchrun world of "
                             f"{size} processes: they must be equal")
        result = _worker(rank, args, None)
        if rank:
            return None
    else:
        import torch.multiprocessing as mp

        store = os.path.join(out_dir, f".mesh_{uuid.uuid4().hex}")
        done = os.path.join(out_dir, "result.json")
        if os.path.exists(done):
            os.remove(done)
        try:
            # the workers by module name: this module may be __main__
            name = "trase_tpu_torch.tools.validate_scale"
            worker = sys.modules[name]._worker if name in sys.modules \
                else _worker
            mp.start_processes(worker, args=(args, store), nprocs=args.mesh,
                               join=True, start_method="spawn")
        finally:
            shutil.rmtree(store, ignore_errors=True)
        with open(done) as f:
            result = json.load(f)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
