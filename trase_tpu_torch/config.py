"""Config system: dataclass groups + argparse reflection + cfg persistence.

Behavioral contract: arguments/__init__.py in the reference — its
loading and pipeline groups with the same field names, defaults, and shorthand-flag
convention (fields listed in `_shorthand` get a one-letter alias), plus
`get_combined_args` merging a saved config under model_path. The saved
format here is JSON (`cfg_args.json`); the reference's eval()-based
`cfg_args` Namespace repr is also parsed, READ-ONLY and without eval,
for checkpoint compatibility.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from dataclasses import dataclass, field, fields


def _add_group(parser: argparse.ArgumentParser, cls, name: str,
               shorthand: set[str], fill_none: bool = False):
    group = parser.add_argument_group(name)
    for f in fields(cls):
        default = None if fill_none else (
            f.default if f.default is not dataclasses.MISSING
            else f.default_factory()
        )
        t = f.type if isinstance(f.type, type) else type(
            f.default if f.default is not dataclasses.MISSING
            else f.default_factory()
        )
        names = ["--" + f.name]
        if f.name in shorthand:
            names.append("-" + f.name[0])
        if t is bool:
            group.add_argument(*names, default=default, action="store_true")
        else:
            group.add_argument(*names, default=default, type=t)


def _extract(cls, args: argparse.Namespace):
    kwargs = {}
    for f in fields(cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            kwargs[f.name] = getattr(args, f.name)
    return cls(**kwargs)


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    load2gpu_on_the_fly: bool = False
    is_blender: bool = False
    is_6dof: bool = False
    load_mask_on_the_fly: bool = False
    load_image_on_the_fly: bool = False
    end_frame: int = -1
    mask_black_bg: bool = False

    _shorthand = {"source_path", "model_path", "images", "resolution",
                  "white_background"}

    @classmethod
    def add_to_parser(cls, parser, sentinel=False):
        _add_group(parser, cls, "Loading Parameters", cls._shorthand,
                   fill_none=sentinel)

    @classmethod
    def extract(cls, args):
        g = _extract(cls, args)
        g.source_path = os.path.abspath(g.source_path)
        return g


@dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False

    _shorthand = frozenset()

    @classmethod
    def add_to_parser(cls, parser):
        _add_group(parser, cls, "Pipeline Parameters", set())

    @classmethod
    def extract(cls, args):
        return _extract(cls, args)


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    warm_up: int = 3_000
    deform_lr_max_steps: int = 40_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    warm_up_3d_features: int = 10000
    iterative_opt_interval: int = 1000
    monitor_mem: bool = False
    lambda_reg_deform: float = 0.0
    num_kmeans: int = 16
    num_neighbors: int = 128
    deform_type: str = "DeformNetwork"
    num_sampled_pixels: int = 5000
    smooth_K: int = 16
    rfn: float = 1.0
    num_sampled_masks: int = 50
    contrastive_mode: str = "soft"
    hard_positive_th: float = 0.75
    hard_negative_th: float = 0.5
    # no reference counterpart (trase_tpu's): the pair-budget overflow
    # warning threshold and the auto-escalation cap for
    # pairs_per_gaussian (0 disables auto-escalation)
    overflow_warn_frac: float = 0.02
    max_pairs_per_gaussian: int = 32

    _shorthand = frozenset()

    @classmethod
    def add_to_parser(cls, parser):
        _add_group(parser, cls, "Optimization Parameters", set())

    @classmethod
    def extract(cls, args):
        return _extract(cls, args)


def save_cfg(model_path: str, args: argparse.Namespace):
    os.makedirs(model_path, exist_ok=True)
    payload = {k: v for k, v in vars(args).items()
               if isinstance(v, (int, float, str, bool, list, type(None)))}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(payload, f, indent=1)
    # reference-compatible cfg_args (Namespace repr) for cross-tooling
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write("Namespace(" + ", ".join(
            f"{k}={v!r}" for k, v in payload.items()) + ")")


def _parse_namespace_repr(text: str) -> dict:
    """Parse `Namespace(a=1, b='x')` without eval()."""
    m = re.match(r"^\s*Namespace\((.*)\)\s*$", text, re.S)
    if not m:
        return {}
    body = m.group(1)
    try:
        expr = ast.parse(f"dict({body})", mode="eval")
        out = {}
        for kw in expr.body.keywords:
            out[kw.arg] = ast.literal_eval(kw.value)
        return out
    except (SyntaxError, ValueError):
        return {}


def get_combined_args(parser: argparse.ArgumentParser,
                      argv=None) -> argparse.Namespace:
    """Merge saved training config with the command line (saved values
    fill anything the command line left at None)."""
    args_cmdline = parser.parse_args(argv if argv is not None
                                     else sys.argv[1:])
    merged = {}
    mp = getattr(args_cmdline, "model_path", None)
    if mp:
        json_path = os.path.join(mp, "cfg_args.json")
        ns_path = os.path.join(mp, "cfg_args")
        if os.path.exists(json_path):
            with open(json_path) as f:
                merged.update(json.load(f))
        elif os.path.exists(ns_path):
            with open(ns_path) as f:
                merged.update(_parse_namespace_repr(f.read()))
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return argparse.Namespace(**merged)
