"""What every mode of the benchmark shares: finding its files by name,
the device record, the result line, the profiled stretch and its
reading, the spans, and the check's comparison.

Nothing here imports the port: the modes do.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import os
import statistics
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "trase_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def load_json(kind: str, name: str) -> dict:
    """port_bench/<kind>/<name>.json."""
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """port_bench/<kind>/<name>.py as a module of its own."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, ext: str = ".json") -> list:
    """Every name of port_bench/<kind>/ with the extension."""
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(BENCH_DIR, kind))
                  if f.endswith(ext) and not f.startswith("_"))


def forbidden_modules(modules=None) -> list:
    """Loaded modules (of sys.modules by default) whose top-level name is
    jax, jaxlib, flax or the JAX package, compared whole
    (trase_tpu_torch is not trase_tpu)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host-clock spans by name, kept in memory: wrap(module, attribute,
    name) times each call of a function the port exposes, from outside."""

    def __init__(self):
        self.durations: dict = {}
        self._saved = []

    def wrap(self, module, attr: str, name: str):
        fn = getattr(module, attr)
        out = self.durations.setdefault(name, [])

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                out.append(time.perf_counter() - t0)

        self._saved.append((module, attr, fn))
        setattr(module, attr, wrapped)

    def restore(self):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()


def sync(torch, dev):
    """Wait for the device (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(torch, dev):
    """Return cached blocks to the device after the program is freed."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def device_record(torch, dev) -> dict:
    """The device the run used and the peak memory the process held on
    it (a CPU run, in tests only, says so)."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def memory_gb(torch, dev) -> tuple:
    """The device memory the process holds now and its peak so far, GB
    (nothing on the CPU)."""
    if dev.type != "cuda":
        return (0.0, 0.0)
    return (round(torch.cuda.memory_allocated(dev) / 1e9, 3),
            round(torch.cuda.max_memory_allocated(dev) / 1e9, 3))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def report_rates(ends, seconds: float, what: str):
    """Standard error: how many units ended in each second of the window,
    and the host's load average, to tell a steady run from a noisy one."""
    counts = [0] * (int(seconds) + 1)
    for t in ends:
        counts[min(int(t), len(counts) - 1)] += 1
    print(f"[port_bench] {what} per second {counts}; load average "
          f"{os.getloadavg()}", file=sys.stderr)


# ------------------------------------------------------------ profiling


def profile_stretch(torch, fn, trace_dir: str, dev) -> dict:
    """Run fn() under torch.profiler (CPU and CUDA activities) between
    two synchronises; returns the trace's device intervals and host ops,
    and the stretch's host-clock length."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "stretch.json")
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(torch, dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", "")))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver",
                     "user_annotation"):
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e.get("name", "")))
    return {"device": sorted(dev), "host": sorted(host), "window_s": window_s}


def read_profile(prof: dict) -> dict:
    """busy_s (the union of the device's intervals), device time by
    operation name, the idle gaps between device intervals named by the
    innermost host op that spans each gap's middle, and the traced
    window."""
    dev = prof["device"]
    by_name: dict = {}
    launches: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        launches.setdefault(n, []).append((e - s) * 1e-6)
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    host = prof["host"]
    starts = [s for s, _, _ in host]
    idle: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # host ops nest: the innermost one spanning `mid` is the one of
        # latest start among those that do
        name = "host outside any traced op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": prof["window_s"],
            "by_name": by_name, "launches": launches,
            "device_ops": top(by_name),
            "idle_gaps": top(idle)}


def kernel_seconds(by_name: dict, patterns) -> float:
    """Device seconds of the operations whose names contain one of
    `patterns`."""
    return sum(v for k, v in by_name.items()
               if any(p in k for p in patterns))


# -------------------------------------------------------------- output


def emit(result: dict, checks: dict):
    """The check's numbers as the last lines of standard error, and the
    result as the last line of standard output, checks last."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    line = {k: result[k] for k in RESULT_KEYS}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each reading beside its limit; correct when every reading is at
    or under its limit and finite."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = float(limits[name])
        value = float(value)
        good = value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def gap_by_worst_leaf(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """max over leaves of |prog norm - ref norm| / max(ref norm of the
    leaf, median ref norm), leaves in `skip` left out. Returns the value
    and the leaf that set it."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    worst, name = 0.0, ""
    for k in keys:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst or not g == g:
            worst, name = g, k
    return worst, name
