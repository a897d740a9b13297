"""A benchmark cell read through the port's own spans and counters:

    python tools/bench_spans.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--spans 0|1] [--sync_check N] [--out DIR]

Runs port_bench/run.py's cell in this process, with its arguments, its
set-up, its window and its result line, and reads the spans and counters
of trase_tpu_torch/utils/trace.py beside it (port_bench itself reads only
its spans wrapped from outside and the profiler's ATen ops):

- --spans 1 records the spans in the timed window (and, with --trace 1,
  in the profiled stretch); --spans 0 leaves them off, as the benchmark
  does, so a pair of runs gives what recording costs;
- after the window, the spans' means: ``trase.step`` per step call (the
  inside twin of ``step_enqueue_ms.train``), ``trase.iteration`` less its
  step per iteration (the twin of ``loop_host_ms.train``), the step's
  parts, the fetch's wait and upload per iteration, a mask decode, the
  cache counter's hit shares over the window, the mask_fetch counter's
  misses and bytes by path (bits or float32), the nnfm counter's calls
  by size (a style cell: its step's parts include ``.vgg``), the kernels'
  launches by instantiation (``layout_launches``; the smoothing backward's
  per step) and the smoothing maps transposed, with the largest in-degree
  seen (``smooth_map``);
- with --trace 1, the profiled stretch's idle device time put down to the
  innermost ``trase.`` span whose time covers each gap's middle
  (``idle_by_span``), the share of it inside ``trase.step``, and the idle
  time outside any host op;
- --sync_check N runs N iterations with spans off, then N with spans on,
  before the window, each under ``torch.cuda.set_sync_debug_mode("warn")``
  and counts the synchronisations each warned of;
- --pair_seconds S runs two windows of S seconds before the timed one,
  spans off and on in an order the seed's parity sets, and reports each
  one's rate: a pair inside one process, whose level the host sets.

One JSON line ``[bench_spans] {...}`` goes to standard error, and with
--out to DIR/<cell>_<seed>_t<trace>_s<spans>.json.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from port_bench import run as R  # noqa: E402  (starts the set-up clock)
from port_bench import harness as HB  # noqa: E402
from trase_tpu_torch.utils import trace  # noqa: E402

OUTSIDE = "outside program spans"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sync_check", type=int, default=0)
    ap.add_argument("--pair_seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    return ap.parse_known_args(argv)


COUNTERS = ("cache", "mask_fetch", "nnfm", "layout_launches", "smooth_map")


def _counter_delta(name: str, before: dict) -> dict:
    now = trace.counter(name)
    return {".".join(map(str, k)): now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0)}


def read_window(spans: list, cache: dict, mask_fetch: dict, nnfm: dict,
                launches: dict, smooth_map: dict) -> dict:
    """What the window's spans and the counters read (each counter's
    change over the window; the smooth_map counter's largest in-degree as
    it stands)."""
    s = trace.summarize(spans)
    biggest = trace.counter("smooth_map").get(("max_in_degree",))
    smooth_map = {k: v for k, v in smooth_map.items() if k != "max_in_degree"}
    if biggest is not None:
        smooth_map["max_in_degree"] = biggest
    counters = {"cache": cache, "mask_fetch": mask_fetch, "nnfm": nnfm,
                "layout_launches": launches, "smooth_map": smooth_map}
    if "trase.step" not in s or "trase.iteration" not in s:
        return {"spans": s, **counters}
    steps, its = s["trase.step"]["count"], s["trase.iteration"]["count"]

    def per(name, n):
        return s[name]["total_ms"] / n if name in s else None

    out = {"iterations": its, "steps": steps,
           "step_span_ms": per("trase.step", steps),
           "loop_span_ms": (s["trase.iteration"]["total_ms"]
                            - s["trase.step"]["total_ms"]) / its,
           "step_self_share": (s["trase.step"]["self_ms"]
                               / s["trase.step"]["total_ms"])}
    for part in ("deform", "render", "vgg", "loss", "backward", "adam"):
        out[f"{part}_host_ms"] = per(f"trase.step.{part}", steps)
    for part in ("fetch", "fetch.wait", "fetch.upload", "read_metrics"):
        out[f"{part.replace('.', '_')}_ms"] = per(f"trase.loop.{part}", its)
    if "trase.masks.decode" in s:
        d = s["trase.masks.decode"]
        out["mask_decode_ms"] = d["total_ms"] / d["count"]
        out["mask_decodes"] = d["count"]
        out["decode_threads"] = sorted({x.thread for x in spans
                                        if x.name == "trase.masks.decode"})
    for kind in ("gt", "masks"):
        hit, miss = cache.get(f"{kind}.hit", 0), cache.get(f"{kind}.miss", 0)
        if hit + miss:
            out[f"{kind}_hit_share"] = 100.0 * hit / (hit + miss)
            if "trase.loop.fetch.upload" in s and miss:
                out[f"{kind}_upload_ms_per_miss"] = (
                    s["trase.loop.fetch.upload"]["total_ms"] / miss)
    if "smooth_rows_bwd" in launches:
        out["smooth_rows_bwd_per_step"] = launches["smooth_rows_bwd"] / steps
    out.update(counters)
    out["spans"] = s
    return out


def _gaps(dev: list) -> list:
    """The idle gaps between the union of the device's intervals."""
    gaps, cur_e = [], None
    for s, e, _ in dev:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def _union(intervals: list) -> list:
    """The union of (start, end, ...) intervals sorted by start, as
    disjoint [start, end] pairs."""
    out: list = []
    for s, e, *_ in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_stretch(prof: dict) -> dict:
    """The profiled stretch's idle time by innermost trase. span, inside
    trase.step, and outside any host op (profiler microseconds), and the
    device time of each kernel by name, longest first."""
    gaps = _gaps(prof["device"])
    by_kernel: dict = {}
    for a, b, name in prof["device"]:
        by_kernel[name[:96]] = by_kernel.get(name[:96], 0.0) + (b - a) * 1e-6
    spans = sorted(h for h in prof["host"] if h[2].startswith("trase."))
    starts = [h[0] for h in spans]
    host = _union(prof["host"])
    host_starts = [h[0] for h in host]
    by_span: dict = {}
    in_step = outside_any = 0.0
    for a, b in gaps:
        mid, dur = 0.5 * (a + b), (b - a) * 1e-6
        # spans nest: the innermost covering `mid` is the latest started
        covering = [h for h in spans[:bisect.bisect_right(starts, mid)]
                    if h[1] >= mid]
        name = covering[-1][2] if covering else OUTSIDE
        by_span[name] = by_span.get(name, 0.0) + dur
        if any(h[2] == "trase.step" for h in covering):
            in_step += dur
        i = bisect.bisect_right(host_starts, mid) - 1
        if i < 0 or host[i][1] < mid:
            outside_any += dur
    idle = sum((b - a) * 1e-6 for a, b in gaps)
    return {"idle_s": idle, "window_s": prof["window_s"],
            "idle_by_span": sorted(by_span.items(), key=lambda kv: -kv[1]),
            "idle_in_spans_share": (100.0 * (idle - by_span.get(OUTSIDE, 0))
                                    / idle if idle else None),
            "idle_in_step_share": 100.0 * in_step / idle if idle else None,
            "idle_outside_any_op_s": outside_any,
            "annotations": len(spans),
            "device_s_by_kernel": sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])}


def sync_check(torch, advance, first_iter: int, n: int):
    """n iterations (advance(first_iter, n)) with spans off, then n on,
    each under the sync debug mode; returns the next iteration and the
    warnings each counted."""
    counts = {}
    for on in (False, True):
        trace.enable(on)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                advance(first_iter, n)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                trace.enable(False)
                trace.take()
        texts = [str(w.message) for w in caught]
        counts["on" if on else "off"] = {
            "iterations": [first_iter + 1, first_iter + n],
            "synchronizing": sum("synchroniz" in t for t in texts),
            "warnings": len(texts),
            "kinds": sorted({t.split("\n")[0][:120] for t in texts})}
        first_iter += n
    return first_iter, counts


def patch(mode, opts, report: dict):
    """Wrap the mode's window, stretch and run to record and read the
    spans."""
    window, stretch, run = mode.window, mode.stretch, mode.run

    def advance(run_, first_iter, n):
        """n iterations of the mode's loop: the style entry or train."""
        if hasattr(mode, "drive"):
            mode.drive(run_, first_iter, n)
            return
        run_.trainer.opt.iterations = first_iter + n
        run_.trainer.train(first_iter=first_iter, progress=False)

    def traced_window(torch, run_, first_iter, seconds):
        if opts.sync_check:
            first_iter, report["sync_check"] = sync_check(
                torch, lambda first, n: advance(run_, first, n), first_iter,
                opts.sync_check)
        if opts.pair_seconds:
            report["pair"] = {}
            for on in ((False, True) if report["seed"] % 2 else (True, False)):
                trace.enable(on)
                n, dt, _ = window(torch, run_, first_iter, opts.pair_seconds)
                trace.enable(False)
                trace.take()
                report["pair"]["on" if on else "off"] = n / dt
                first_iter += n
        before = {c: dict(trace.counter(c)) for c in COUNTERS}
        trace.take()
        trace.enable(bool(opts.spans))
        try:
            out = window(torch, run_, first_iter, seconds)
        finally:
            trace.enable(False)
        report["window"] = read_window(
            trace.take(), *[_counter_delta(c, before[c]) for c in COUNTERS])
        report["window"]["interval_ms"] = 1e3 * statistics.fmean(out[2])
        return out

    def traced_stretch(torch, run_, first_iter, n, trace_dir):
        trace.enable(bool(opts.spans))
        try:
            out = stretch(torch, run_, first_iter, n, trace_dir)
        finally:
            trace.enable(False)
            trace.take()
        report["stretch"] = read_stretch(out[0])
        return out

    def traced_run(torch, ctx):
        result = run(torch, ctx)
        m = result.get("measure")
        if m and m.get("step_s"):
            step = statistics.fmean(m["step_s"])
            report["outside"] = {
                "step_enqueue_ms": 1e3 * step,
                "loop_host_ms": 1e3 * (statistics.fmean(m["iteration_s"])
                                       - step)}
        report["end_to_end"] = result["end_to_end"]
        return result

    mode.window, mode.stretch, mode.run = (traced_window, traced_stretch,
                                           traced_run)


def instrumented(opts, report: dict, fn, *args):
    """fn(*args) with every mode the harness loads patched."""
    load = HB.load_module

    def load_module(kind, name):
        mod = load(kind, name)
        if kind == "modes":
            patch(mod, opts, report)
        return mod

    HB.load_module = load_module
    try:
        return fn(*args)
    finally:
        HB.load_module = load


def main(argv=None) -> int:
    opts, rest = parse_args(argv)
    args = R.parse_args(rest)
    report = {"workload": args.workload, "seed": args.seed,
              "trace": args.trace, "spans": opts.spans}
    rc = instrumented(opts, report, R.main, rest)
    line = json.dumps(report)
    print(f"[bench_spans] {line}", file=sys.stderr, flush=True)
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        name = (f"{args.workload}_{args.seed}_t{args.trace}"
                f"_s{opts.spans}.json")
        with open(os.path.join(opts.out, name), "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
