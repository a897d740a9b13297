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

Not ported yet, and refused when given (ROADMAP.md, Queue 1): training
checkpoints (``--checkpoint_iterations``, ``--start_checkpoint``,
``--load_iteration``) and ``--profile_iters`` (item 2), ``--mesh`` and
``--mesh_backend`` (item 13). ``--ip`` and ``--port`` are accepted and
unused, as in the root CLI.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from .config import ModelParams, OptimizationParams, PipelineParams, save_cfg

# flags whose feature is not ported: (flag, its value when not given,
# the ROADMAP item that ports it)
NOT_PORTED = (
    ("checkpoint_iterations", [], "Queue 1 item 2"),
    ("start_checkpoint", None, "Queue 1 item 2"),
    ("load_iteration", -1, "Queue 1 item 2"),
    ("profile_iters", None, "Queue 1 item 2"),
    ("mesh", 0, "Queue 1 item 13"),
    ("mesh_backend", None, "Queue 1 item 13"),
)


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
                        help="rasterizer per-tile gaussian capacity (kept "
                             "for config parity; the tiled compositor "
                             "composites every binned pair)")
    parser.add_argument("--pairs_per_gaussian", type=int, default=8)
    parser.add_argument("--pack_features",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="composite the 32 feature channels as "
                             "bf16 pairs (default; --no-pack_features "
                             "composites them in float32)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="devices to train over (0 = one; more is not "
                             "ported)")
    parser.add_argument("--mesh_backend", type=str, default=None,
                        choices=[None, "pallas", "dense"],
                        help="sharded compositor backend (not ported)")
    parser.add_argument("--profile_iters", nargs=2, type=int, default=None,
                        metavar=("START", "STOP"),
                        help="device trace over this iteration range (not "
                             "ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, default) or cpu")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check a command line: a flag whose feature is not ported
    raises (argparse's error, exit 2) when it is given a value other than
    its default."""
    parser = make_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    for name, unset, item in NOT_PORTED:
        if getattr(args, name) != unset:
            parser.error(f"--{name} is not ported to trase_tpu_torch yet "
                         f"(ROADMAP.md, {item})")
    args.save_iterations.append(args.iterations)
    return args


def main(argv=None):
    args = parse_args(argv)

    from . import resolve_device

    device = resolve_device(args.device)
    dataset = ModelParams.extract(args)
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    if not dataset.model_path:
        import uuid

        dataset.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    print("Optimizing " + dataset.model_path)
    os.makedirs(dataset.model_path, exist_ok=True)
    args.model_path = dataset.model_path
    save_cfg(dataset.model_path, args)

    from .data.scene import Scene
    from .engine.loop import Trainer
    from .ops.rasterize import RasterConfig

    scene = Scene(dataset, device=device)
    raster_cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian,
                              max_per_tile=args.max_per_tile,
                              pack_features=args.pack_features)
    trainer = Trainer(dataset, opt, pipe, scene, raster_cfg=raster_cfg,
                      device=device)

    # --detect_anomaly: the reference's torch.autograd.set_detect_anomaly
    # (reference train.py:506,521); --debug_from arms it from that
    # iteration on. The mode is restored when training ends.
    anomaly = torch.is_anomaly_enabled()
    on_iteration = None
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    elif args.debug_from >= 0:
        def on_iteration(tr, iteration, metrics):
            if iteration >= args.debug_from:
                torch.autograd.set_detect_anomaly(True)
    try:
        trainer.train(testing_iterations=set(args.test_iterations),
                      saving_iterations=set(args.save_iterations),
                      progress=not args.quiet, on_iteration=on_iteration)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
