"""Training CLI of the port: a whole TRASE run on the card.

    python -m trase_tpu_torch.train -s <data> -m <model> --iterations N

Counterpart of the root train.py (reference train.py:497-525): the
Deformable-3DGS stage with densification and opacity resets, then, from
``--warm_up_3d_features`` on (default 10000) when the dataset has SAM
masks, GAUSSIAN and FEATURE blocks alternating every
``--iterative_opt_interval`` steps. It takes the root CLI's flags with
their defaults and its cfg persistence under the model path; the
snapshot at each --save_iterations (and at the last iteration) is what
``python -m trase_tpu_torch.render`` and the root render.py read, and
each --test_iterations prints the test and train views' L1 and PSNR.
Runs on the card (``--device cuda``, the default) or, with ``--device
cpu``, on the CPU through the kernels' plain versions.

Run state, as the root CLI wires it (train.py:88-110, :131-172):
``--checkpoint_iterations`` writes ``<model>/chkpnt<N>.pkl``;
``--start_checkpoint`` resumes from one of those, from trase_tpu's
``chkpnt<N>.pkl`` or from the reference's ``chkpnt<N>.pth``;
``--load_iteration N`` starts at iteration N from the snapshot
``point_cloud/iteration_N`` (the deform net starts from its init, as in
trase_tpu); ``--profile_iters START STOP`` records a ``torch.profiler``
trace (CPU and, on the card, CUDA activity) of iterations START+1..STOP
into ``<model>/trace/`` as a Chrome trace; the port's spans
(utils/trace.py: trase.iteration, trase.loop.*, trase.step.*,
trase.render.*, ...) are on for those iterations, so the trace carries
them as ``user_annotation`` events on the kernels' timeline, and their
summary is printed at its end. Python's, numpy's and torch's
global generators are seeded with 0 first (the reference's safe_state),
so the camera shuffle, and with it a resumed run, repeats.

``--mesh N`` trains over a world of N ranks (parallel/trainer.py:
ShardedTrainer): rank r holds block r of the gaussians and composites
slab r of the image's tile rows, NCCL on ``cuda:r`` (``--device cuda``)
or gloo on the CPU (``--device cpu``). Started alone, the CLI spawns the
N ranks itself (torch.multiprocessing; the rendezvous is a file store
under the model path); under ``torchrun --nproc_per_node N -m
trase_tpu_torch.train ... --mesh N`` each process joins torchrun's world.
On CUDA N may not exceed the device count: NCCL cannot put two ranks on
one card, and the CLI exits at once, naming both numbers. Rank 0 alone
prints and writes; its checkpoints and snapshots have the single-device
layout. ``--mesh_backend`` takes None or ``pallas``, which run the same
slab kernels; ``dense`` (trase_tpu's XLA compositor) is not ported.
``--ip`` and ``--port`` are accepted and unused, as in the root CLI.
"""
from __future__ import annotations

import argparse
import os
import random
import shutil
import sys
import uuid

import numpy as np
import torch

from .config import ModelParams, OptimizationParams, PipelineParams, save_cfg
from .utils import trace

# flags whose feature is not ported: (flag, its value when not given,
# the ROADMAP item that ports it)
NOT_PORTED = ()


def make_parser() -> argparse.ArgumentParser:
    """The root train.py's parser (train.py:22-64), flag for flag and
    default for default, plus --device."""
    parser = argparse.ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(parser)
    OptimizationParams.add_to_parser(parser)
    PipelineParams.add_to_parser(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true",
                        default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[1_000, 7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[1_000, 7_000, 30_000, 60_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--load_iteration", type=int, default=-1)
    parser.add_argument("--max_per_tile", type=int, default=1024,
                        help="the root CLI's per-tile capacity, accepted; "
                             "the tiled compositor bins every pair, so "
                             "the value goes nowhere")
    parser.add_argument("--pairs_per_gaussian", type=int, default=8)
    parser.add_argument("--pack_features",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="composite the 32 feature channels as "
                             "bf16 pairs (default; --no-pack_features "
                             "composites them in float32)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="train over a world of N ranks, one card "
                             "each (0 = one device, no world)")
    parser.add_argument("--mesh_backend", type=str, default=None,
                        choices=[None, "pallas", "dense"],
                        help="sharded compositor: None and pallas run the "
                             "compositor's slab mode; dense is not ported")
    parser.add_argument("--profile_iters", nargs=2, type=int, default=None,
                        metavar=("START", "STOP"),
                        help="torch.profiler trace of iterations START+1.."
                             "STOP into <model_path>/trace (Chrome trace; "
                             "open with perfetto or chrome://tracing)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, default) or cpu")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check a command line: a flag whose feature is not ported
    raises (argparse's error, exit 2) when it is given a value other than
    its default, and so do --profile_iters with STOP <= START, --mesh_backend
    dense, and a --mesh on CUDA larger than the device count."""
    parser = make_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    for name, unset, item in NOT_PORTED:
        if getattr(args, name) != unset:
            parser.error(f"--{name} is not ported to trase_tpu_torch yet "
                         f"(ROADMAP.md, {item})")
    if args.profile_iters and args.profile_iters[1] <= args.profile_iters[0]:
        parser.error("--profile_iters STOP must be > START")
    if args.mesh_backend == "dense":
        parser.error("--mesh_backend dense is not ported: the port has one "
                     "compositor, whose slab mode --mesh runs (ROADMAP.md, "
                     "Queue 1, not to port: the dense backend)")
    if args.mesh < 0:
        parser.error("--mesh must be >= 0")
    if args.mesh > 0 and torch.device(args.device).type == "cuda":
        from .parallel.world import check_devices

        try:
            check_devices(args.mesh)
        except RuntimeError as e:
            parser.error(f"--mesh {args.mesh}: {e}")
    args.save_iterations.append(args.iterations)
    return args


class IterationProfiler:
    """torch.profiler over iterations START+1..STOP, driven from the
    loop's on_iteration hook (called at the end of each iteration): it
    starts at the end of START and stops at the end of STOP (or at the
    first iteration past START, STOP when one is skipped), writing
    <trace_dir>/trace_<START>_<STOP>.json. CUDA activity is recorded
    when the device is the card, and a trace on the card without device
    time raises, as does any failure to start. The port's spans are
    recorded while it traces; it prints each one's count and mean total
    and self time at the end."""

    def __init__(self, start: int, stop: int, trace_dir: str, device):
        self.start, self.stop, self.trace_dir = start, stop, trace_dir
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None
        self.path = None

    def __call__(self, tr, iteration, metrics):
        if self.prof is None and self.start <= iteration < self.stop:
            os.makedirs(self.trace_dir, exist_ok=True)
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
            trace.enable(True)
            print(f"[profile] tracing -> {self.trace_dir}")
        elif self.prof is not None and iteration >= self.stop:
            self.finish()

    def finish(self):
        """Stop the trace, if one runs, and write it."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.stop()
        trace.enable(False)
        for name, d in sorted(trace.summarize(trace.take()).items()):
            print(f"[profile] span {name}: {d['count']} x "
                  f"{d['total_ms'] / d['count']:.3f} ms "
                  f"(self {d['self_ms'] / d['count']:.3f} ms)")
        if len(self.activities) > 1 and not any(
                str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0
                for e in prof.key_averages()):
            raise RuntimeError("torch.profiler recorded no CUDA activity")
        self.path = os.path.join(self.trace_dir,
                                 f"trace_{self.start}_{self.stop}.json")
        prof.export_chrome_trace(self.path)
        print(f"[profile] trace stopped: {self.path}")


def main(argv=None):
    """Parse the command line and train: on one device, or with --mesh N
    over N ranks (joining torchrun's world when WORLD_SIZE is set, else
    spawning them). Returns the trainer, or under torchrun this rank's;
    None when it spawned the ranks."""
    args = parse_args(argv)
    dataset = _prepare_model_dir(args)
    if args.mesh == 0:
        return train_run(args, dataset)
    if "WORLD_SIZE" in os.environ:
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if size != args.mesh:
            raise SystemExit(f"--mesh {args.mesh} under a torchrun world of "
                             f"{size} processes: they must be equal")
        return _mesh_worker(rank, args, dataset, None)
    import torch.multiprocessing as mp

    store = os.path.join(dataset.model_path, f".mesh_{uuid.uuid4().hex}")
    try:
        # the workers by module name: this module may be __main__
        worker = sys.modules["trase_tpu_torch.train"]._mesh_worker \
            if "trase_tpu_torch.train" in sys.modules else _mesh_worker
        mp.start_processes(worker, args=(args, dataset, store),
                           nprocs=args.mesh, join=True,
                           start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    print("\nTraining complete.")
    return None


def _prepare_model_dir(args):
    """The model directory and its cfg_args, written once per run."""
    dataset = ModelParams.extract(args)
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    print("Optimizing " + dataset.model_path)
    os.makedirs(dataset.model_path, exist_ok=True)
    args.model_path = dataset.model_path
    save_cfg(dataset.model_path, args)
    return dataset


def _mesh_worker(rank, args, dataset, store_dir):
    """One rank of a --mesh run: join the world (a file store in
    `store_dir`, or torchrun's environment), train, leave; returns the
    rank's trainer. Ranks other than 0 print nothing."""
    from .parallel.world import close_world, init_world

    if rank:
        sys.stdout = open(os.devnull, "w")
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.mesh))
    world = init_world(args.mesh, rank, args.device, store_dir=store_dir)
    try:
        return train_run(args, dataset, world)
    finally:
        close_world()


def train_run(args, dataset, world=None):
    """Build the scene and the trainer (a ShardedTrainer in a world), load
    what the flags name, train, and return the trainer."""
    # the reference's safe_state: the camera shuffle (python's random)
    # and every global draw repeat from run to run (and from rank to rank)
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)

    from . import resolve_device

    device = resolve_device(args.device) if world is None else world.device
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)

    from .data.scene import Scene
    from .engine.loop import Trainer
    from .ops.rasterize import RasterConfig

    load_iter = args.load_iteration if args.load_iteration != -1 else None
    # a world builds the global state on the host (ShardedTrainer)
    scene = Scene(dataset, load_iteration=load_iter,
                  device=device if world is None else "cpu")
    raster_cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian,
                              pack_features=args.pack_features)
    if world is None:
        trainer = Trainer(dataset, opt, pipe, scene, raster_cfg=raster_cfg,
                          device=device)
    else:
        from .parallel.trainer import ShardedTrainer

        trainer = ShardedTrainer(dataset, opt, pipe, scene, world,
                                 raster_cfg=raster_cfg)
    lead = world is None or world.rank == 0

    # --load_iteration starts from that snapshot's gaussians; the deform
    # net is not reloaded from deform/iteration_N (trase_tpu's behaviour)
    first_iter = 0
    if args.load_iteration != -1:
        first_iter = args.load_iteration
    if args.start_checkpoint:
        first_iter = trainer.load_ckpt(args.start_checkpoint)

    # --detect_anomaly: the reference's torch.autograd.set_detect_anomaly
    # (reference train.py:506,521); --debug_from arms it from that
    # iteration on. The mode is restored when training ends.
    anomaly = torch.is_anomaly_enabled()
    hooks = []
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    elif args.debug_from >= 0:
        def debug_hook(tr, iteration, metrics):
            if iteration >= args.debug_from:
                torch.autograd.set_detect_anomaly(True)

        hooks.append(debug_hook)
    profiler = None
    if args.profile_iters and lead:
        profiler = IterationProfiler(
            *args.profile_iters, os.path.join(dataset.model_path, "trace"),
            device)
        hooks.append(profiler)

    def on_iteration(tr, iteration, metrics):
        for hook in hooks:
            hook(tr, iteration, metrics)

    try:
        trainer.train(first_iter=first_iter,
                      testing_iterations=set(args.test_iterations),
                      saving_iterations=set(args.save_iterations),
                      checkpoint_iterations=set(args.checkpoint_iterations),
                      progress=not args.quiet and lead,
                      on_iteration=on_iteration if hooks else None)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if profiler is not None:
            profiler.finish()
    trainer.profile_trace = None if profiler is None else profiler.path
    if world is None:
        print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
