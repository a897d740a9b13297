"""Training CLI of the port: a whole TRASE run on the card.

    python -m trase_tpu_torch.train -s <data> -m <model> --iterations N

Counterpart of the root train.py (reference train.py:497-525): the
Deformable-3DGS stage with densification and opacity resets, then, from
``--warm_up_3d_features`` on (default 10000) when the dataset has SAM
masks, GAUSSIAN and FEATURE blocks alternating every
``--iterative_opt_interval`` steps. Same flag groups (Model /
Optimization / Pipeline) and cfg persistence under the model path; the
snapshot at each --save_iterations (and at the last iteration) is what
``python -m trase_tpu_torch.render`` and the root render.py read. Runs
on the card (``--device cuda``, the default) or, with ``--device cpu``,
on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import sys

from .config import ModelParams, OptimizationParams, PipelineParams, save_cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(parser)
    OptimizationParams.add_to_parser(parser)
    PipelineParams.add_to_parser(parser)
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[1_000, 7_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--pairs_per_gaussian", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, default) or cpu")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    args.save_iterations.append(args.iterations)

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
    raster_cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    trainer = Trainer(dataset, opt, pipe, scene, raster_cfg=raster_cfg,
                      device=device)
    trainer.train(saving_iterations=set(args.save_iterations),
                  progress=not args.quiet)
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
