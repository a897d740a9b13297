"""The benchmark of trase_tpu_torch on NVIDIA GPUs.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell, in this process: port_bench/workloads/<name>.json names
its configuration (port_bench/configs/), its traffic
(port_bench/traffic/), its mode (port_bench/modes/<mode>.py), its
per-layer metrics (port_bench/metrics/<metric>.py) and the limits of its
check. The mode makes the inputs from the seed, sets the program up,
measures for --seconds and checks what the timed path produced against
the plain reference (port_bench/reference/). The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device
(with --trace 1 also breakdown), and the check's numbers beside their
limits last; the same numbers are the last lines of standard error.
--trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer ones.

Exits 2 without a result when no CUDA device is available, when fewer
devices are present than the cell asks for, or when jax, jaxlib, flax or
the JAX package was loaded; any other failure exits non-zero too.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness as HB  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args) -> types.SimpleNamespace:
    wl = HB.load_json("workloads", args.workload)
    cfg = HB.load_json("configs", wl["config"])
    traffic = HB.load_json("traffic", wl["traffic"])
    trace_dir = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                             "port_bench_trace")
    return types.SimpleNamespace(args=args, workload=wl, cfg=cfg,
                                 traffic=traffic, t_start=T_START,
                                 trace_dir=trace_dir, device=None)


def metrics_of(ctx, result: dict) -> dict:
    """--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer
    metrics, each read by its own reader (a reader that finds nothing
    returns None and the metric is left out)."""
    wl = ctx.workload
    out = {}
    if not ctx.args.trace:
        for m in wl["end_to_end"]:
            out[m["name"]] = {"value": result["end_to_end"][m["name"]],
                              "unit": m["unit"]}
        return out
    for name in wl["per_layer"]:
        reader = HB.load_module("metrics", name)
        value = reader.read(result["measure"])
        if value is not None:
            out[name] = {"value": value, "unit": reader.UNIT}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    ctx = context(args)
    import torch

    chips = int(ctx.workload.get("chips", 1))
    if not torch.cuda.is_available():
        print("no CUDA device is available: the benchmark measures the "
              "card and has no CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} devices, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        return 2
    print(f"[port_bench] {args.workload} seed {args.seed} on "
          f"{HB.power_limit()}", file=sys.stderr, flush=True)
    ctx.device = torch.device("cuda", 0)
    return finish(ctx, torch)


def finish(ctx, torch) -> int:
    """Run the cell's mode on ctx.device, judge it and print the result
    (everything but the look for a card)."""
    args = ctx.args
    mode = HB.load_module("modes", ctx.workload["mode"])
    result = mode.run(torch, ctx)
    print(f"[port_bench] setup_s {result['setup_s']:.3f}, the check "
          f"{result['check_s']:.3f} s", file=sys.stderr)
    bad = HB.forbidden_modules()
    if bad:
        print(f"modules of the JAX side were loaded: {bad}", file=sys.stderr)
        return 2
    correct, checks = HB.judge(result["readings"], ctx.workload["limits"])
    result["correct"] = correct
    result["metrics"] = metrics_of(ctx, result)
    if result.get("detail"):
        print(f"[port_bench] detail {result['detail']}", file=sys.stderr)
    if not args.trace:
        result.pop("breakdown", None)
    HB.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
