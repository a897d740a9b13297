"""A cell shrunk to a CPU test's size: the same files, with the scene,
the image and the run cut down, and a context that drives the rest of a
run on the CPU (no look for a card)."""
from __future__ import annotations

import argparse
import copy
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness as HB  # noqa: E402


def tiny_context(workload: str, seed: int = 3, seconds: float = 1.5,
                 trace: int = 0, tmp: str = "/tmp") -> types.SimpleNamespace:
    import torch

    wl = HB.load_json("workloads", workload)
    cfg = copy.deepcopy(HB.load_json("configs", wl["config"]))
    traffic = copy.deepcopy(HB.load_json("traffic", wl["traffic"]))
    cfg.update(image_width=64, image_height=48, capacity=2048, n_alive=1500)
    cfg["capture"] = [64 * 2, 48 * 2]
    cfg["scene"]["objects"]["count"] = 6
    cfg["masks"].update(per_view=8, large=2)
    cfg["recipe"].update(num_sampled_pixels=256, num_sampled_masks=4)
    traffic.update(cameras=min(traffic["cameras"], 3), frames=2,
                   traced_iterations=2)
    if "warm_up_iterations" in traffic:
        traffic["warm_up_iterations"] = 2
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    return types.SimpleNamespace(args=args, workload=wl, cfg=cfg,
                                 traffic=traffic, t_start=time.perf_counter(),
                                 trace_dir=os.path.join(tmp, "trace"),
                                 device=torch.device("cpu"))
