"""Readings that set a cell's limits: the program's sound runs over many
seeds, the control (the reference computed a precision lower, in the
program's place) and the planted faults, each at the cell's own size.
The benchmark's runs never call this.

    python3 port_bench/controls.py --workload <name> --seeds 1 2 ... \
        --control_seeds 1 2 3 --out readings/controls_<name>.json

Training cells: the program's first three steps through ``train``
against the reference, per seed; the control in bfloat16; the faults
``half_batch`` (the loss over half the image) and ``double`` (one leaf's
update taken twice) in the reference put in the program's place. A state
left unchanged reads 1 by the change measure and needs no run.

A cell whose limits name the densification's numbers also runs its
warm-up, records its first round as a run does, and reads the round
against the reference's; the control is the reference's round with its
arithmetic in bfloat16, and the faults ``threshold_halved`` (the gradient
threshold halved) and ``prune_skipped`` (nothing pruned) are planted in
the reference's round put in the program's place. The statistics of the
checked steps (``densify_stats_gap``) are read for the control and the
step faults too.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from port_bench import harness as HB  # noqa: E402


def train_readings(torch, ctx, seeds, control_seeds) -> dict:
    M = HB.load_module("modes", "train")
    from port_bench.reference import densify as RD

    cfg = dict(ctx.cfg, _traffic=ctx.traffic)
    first_iter = int(ctx.traffic["first_iteration"])
    densify = "densify_rows_gap" in ctx.workload["limits"]
    out = {"sound": {}, "control": {}, "half_batch": {}, "double": {},
           "seconds": {}}
    if densify:
        out.update(round_control={}, threshold_halved={}, prune_skipped={})
    for seed in seeds:
        t0 = time.perf_counter()
        run = M.build(torch, ctx.cfg, ctx.traffic, seed, ctx.device)
        prog = M.checked_steps(torch, run, first_iter)
        record = {}
        if densify:
            M.warm_up(run, first_iter + M.CHECKED_STEPS,
                      int(ctx.traffic["warm_up_iterations"]), record)
        del run
        gc.collect()
        HB.free(torch, ctx.device)
        t1 = time.perf_counter()
        ref = M.reference_run(torch, cfg, seed, prog["calls"], ctx.device,
                              torch.float32)
        HB.sync(torch, ctx.device)
        out["seconds"][seed] = {"program": t1 - t0,
                                "reference": time.perf_counter() - t1}
        got = M.compare(prog, ref)
        if densify:
            got["readings"]["densify_stats_gap"] = M.stats_gap(prog, ref)
            rounds = M.densify_readings(torch, cfg, ctx.traffic, record,
                                        ctx.device)
            got["readings"].update(rounds["readings"])
            got["worst"]["densify"] = rounds["detail"]
        out["sound"][seed] = dict(got["readings"], worst=got["worst"],
                                  skipped=prog["skipped"])
        if seed in control_seeds:
            for name, kw in (("control", {"dtype": torch.bfloat16}),
                             ("half_batch", {"fault": "half_batch"}),
                             ("double", {"fault": "double"})):
                kw.setdefault("dtype", torch.float32)
                alt = M.reference_run(torch, cfg, seed, prog["calls"],
                                      ctx.device, **kw)
                g = M.compare(alt, ref)
                if densify:
                    g["readings"]["densify_stats_gap"] = M.stats_gap(alt, ref)
                out[name][seed] = dict(g["readings"], worst=g["worst"])
            if densify:
                base = M.plain_round(torch, cfg, ctx.traffic, record,
                                     ctx.device)
                before = M.on_device(record["before"], ctx.device)
                for name, kw in (("round_control", {"dtype": torch.bfloat16}),
                                 ("threshold_halved",
                                  {"fault": "threshold_halved"}),
                                 ("prune_skipped", {"fault": "prune_skipped"})):
                    alt = M.plain_round(torch, cfg, ctx.traffic, record,
                                        ctx.device, **kw)
                    g = RD.compare(alt, base, before)
                    out[name][seed] = dict(g["readings"], worst=g["worst"],
                                           counts=alt["counts"])
                del base, before
        del record
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
    wl = HB.load_json("workloads", args.workload)
    import types

    ctx = types.SimpleNamespace(
        workload=wl, cfg=HB.load_json("configs", wl["config"]),
        traffic=HB.load_json("traffic", wl["traffic"]),
        device=torch.device("cuda", 0))
    out = train_readings(torch, ctx, args.seeds, set(args.control_seeds))
    out["device"] = HB.power_limit()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k != "seconds"},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
