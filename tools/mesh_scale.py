"""The validation tool's schedule on one device and over a world of N
devices, on one dataset, in one command:

    python tools/mesh_scale.py --mesh 4 --out DIR [validate_scale flags]

Runs trase_tpu_torch/tools/validate_scale.py's run() twice: on one device
(--mesh 0), then over N ranks spawned here (NCCL with one card each on
--device cuda, gloo on --device cpu). A hook on every rank records the
loss of iterations 1..LOSS_ITERS (before the schedule's first densify), the
host clock at every iteration (it/s over a GAUSSIAN and a FEATURE window
that hold no evaluation and no densify), a torch.profiler window over each
(device busy time and idle share, on the card), and the peak device
memory. Prints one JSON line per run, then a comparison line, and fails
when rank 0's first losses differ from the single device's by more than
LOSS_TOL relative. Without flags it runs chip_smoke.py's scale settings.
"""
import argparse
import json
import os
import shutil
import sys
import time
import uuid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from trase_tpu_torch.tools import validate_scale as V  # noqa: E402

LOSS_ITERS, LOSS_TOL = 10, 1e-4
# windows of chip_smoke.py's scale settings (CS.SCALE_ARGS: GAUSSIAN to
# 149 with a densify at 100, FEATURE from 150, a milestone at 150) clear
# of evaluations and densifies
WINDOWS = {"gaussian": (20, 60), "feature": (160, 200)}
PROFILE = {"gaussian": (60, 80), "feature": (200, 220)}


class Probe:
    """The iteration hook: losses, clocks, profiler windows. Each run
    starts in a fresh process (the ranks) or first in this one (one
    device), so the peak memory is the run's."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.losses, self.clock = [], {}
        self.prof, self.window, self.profiles = None, None, {}

    def __call__(self, tr, iteration, metrics):
        self.clock[iteration] = time.perf_counter()
        if iteration <= LOSS_ITERS:
            self.losses.append(float(metrics["loss"]))
        for name, (start, stop) in PROFILE.items():
            if iteration == start:
                self._start(name)
            elif iteration == stop and self.window == name:
                self._stop(stop - start)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, name):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof, self.window = profile(activities=acts), name
        self.prof.start()
        self.t0 = time.perf_counter()

    def _stop(self, iters):
        self._sync()
        wall = (time.perf_counter() - self.t0) * 1e3 / iters
        self.prof.stop()
        busy = sum(e.self_device_time_total for e in
                   self.prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e3 / iters
        self.profiles[self.window] = {
            "wall_ms": wall, "device_busy_ms": busy if self.device.type
            == "cuda" else None, "idle_share": 1.0 - busy / wall
            if self.device.type == "cuda" else None}
        self.prof, self.window = None, None

    def summary(self, result) -> dict:
        if self.prof is not None:  # a window the run did not finish
            self.prof.stop()
            self.prof, self.window = None, None
        rates = {}
        for name, (a, b) in WINDOWS.items():
            if a in self.clock and b in self.clock:
                rates[name] = (b - a) / (self.clock[b] - self.clock[a])
        return {"losses": self.losses, "iters_per_s_window": rates,
                "profile": self.profiles,
                "peak_gib": torch.cuda.max_memory_allocated(self.device)
                / 2 ** 30 if self.device.type == "cuda" else None,
                "result": result}


def _worker(rank, args, store_dir):
    """One rank: join the world, run the tool with the probe, write the
    rank's summary to <out>/rank<r>.json."""
    from trase_tpu_torch.parallel.world import close_world, init_world

    if rank:
        sys.stdout = open(os.devnull, "w")
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.mesh))
    world = init_world(args.mesh, rank, args.device, store_dir=store_dir)
    try:
        probe = Probe(world.device)
        result = V.run(args, world, on_iteration=probe)
        out = probe.summary(result)
    finally:
        close_world()
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, default=4)
    ap.add_argument("--out", default="mesh_scale_out")
    known, rest = ap.parse_known_args(argv)
    root = os.path.abspath(known.out)
    shutil.rmtree(root, ignore_errors=True)
    one, many = os.path.join(root, "mesh0"), os.path.join(root, "mesh")
    tool_args = rest or CS.SCALE_ARGS
    args = V.parse_args(["--out", one] + tool_args)
    print(f"[mesh_scale] device: {V.card_line(args.device)}", flush=True)

    probe = Probe("cuda:0" if args.device == "cuda" else "cpu")
    single = probe.summary(V.run(args, on_iteration=probe))
    print(json.dumps({"run": "mesh0", **single}), flush=True)

    shutil.copytree(os.path.join(one, "data"), os.path.join(many, "data"))
    margs = V.parse_args(["--out", many, "--mesh", str(known.mesh)]
                         + tool_args)
    store = os.path.join(root, f".mesh_{uuid.uuid4().hex}")
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_worker, args=(margs, store), nprocs=known.mesh,
                           join=True, start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    ranks = []
    for r in range(known.mesh):
        with open(os.path.join(many, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(json.dumps({"run": f"mesh{known.mesh}", "ranks": ranks}),
          flush=True)

    a, b = single["losses"], ranks[0]["losses"]
    rel = max(abs(x - y) / max(abs(x), 1e-12) for x, y in zip(a, b))
    same = all(r["losses"] == b for r in ranks)
    cmp = {"run": "compare", "mesh": known.mesh,
           "first_losses_max_rel": rel, "tol": LOSS_TOL,
           "ranks_agree": same,
           "psnr_test": [single["result"]["psnr_test"],
                         ranks[0]["result"]["psnr_test"]],
           "iters_per_s": [single["result"]["iters_per_s"],
                           ranks[0]["result"]["iters_per_s"]],
           "peak_gib": [single["peak_gib"], [r["peak_gib"] for r in ranks]]}
    print(json.dumps(cmp), flush=True)
    assert len(a) == len(b) == LOSS_ITERS and rel <= LOSS_TOL and same, cmp
    return cmp


if __name__ == "__main__":
    main()
