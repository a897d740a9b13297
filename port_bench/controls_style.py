"""Readings that set a style cell's limits (controls.py's counterpart for
modes/style.py): the program's sound runs over many seeds, the control
and the planted faults, each at the cell's own size. The benchmark's
runs never call this.

    python3 port_bench/controls_style.py --workload n3v-style-step \
        --seeds 1 2 ... --control_seeds 1 2 3 --out <file>.json

Per seed, the program's first three iterations through the loop's style
entry against the reference; for the control seeds also, in the
program's place, the reference with TF32 allowed in the VGG's and the
NNFM's products (the control: the nearest precision below float32 on
the card), and the reference with the faults ``half_rows`` (half the
styled rows updated) and ``double`` (the features_dc update taken
twice). A state left unchanged reads 1 by the change measure and needs
no run.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from port_bench import harness as HB  # noqa: E402

ALTERNATIVES = (("control", {"tf32": True}),
                ("half_rows", {"fault": "half_rows"}),
                ("double", {"fault": "double"}))


def style_readings(torch, ctx, seeds, control_seeds) -> dict:
    M = HB.load_module("modes", "style")
    first_iter = int(ctx.traffic["first_iteration"]) - 1
    out = {name: {} for name in ("sound",) + tuple(a for a, _ in ALTERNATIVES)}
    out["seconds"] = {}
    for seed in seeds:
        t0 = time.perf_counter()
        run = M.build(torch, ctx.cfg, ctx.traffic, seed, ctx.device)
        prog = M.checked_steps(torch, run, first_iter)
        del run
        gc.collect()
        HB.free(torch, ctx.device)
        t1 = time.perf_counter()
        ref = M.reference_run(torch, ctx.cfg, ctx.traffic, seed,
                              prog["calls"], ctx.device)
        HB.sync(torch, ctx.device)
        out["seconds"][seed] = {"program": t1 - t0,
                                "reference": time.perf_counter() - t1}
        got = M.TM.compare(prog, ref)
        out["sound"][seed] = dict(got["readings"], worst=got["worst"],
                                  skipped=prog["skipped"])
        if seed in control_seeds:
            for name, kw in ALTERNATIVES:
                alt = M.reference_run(torch, ctx.cfg, ctx.traffic, seed,
                                      prog["calls"], ctx.device, **kw)
                g = M.TM.compare(alt, ref)
                out[name][seed] = dict(g["readings"], worst=g["worst"])
        print(json.dumps({"seed": seed, "sound": out["sound"][seed]}),
              flush=True)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    wl = HB.load_json("workloads", args.workload)
    ctx = types.SimpleNamespace(
        workload=wl, cfg=HB.load_json("configs", wl["config"]),
        traffic=HB.load_json("traffic", wl["traffic"]),
        device=torch.device("cuda", 0))
    out = style_readings(torch, ctx, args.seeds, set(args.control_seeds))
    out["device"] = HB.power_limit()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k != "seconds"},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
