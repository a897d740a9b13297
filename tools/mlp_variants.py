"""Times variants of the fused deform MLP (trase_tpu_torch/csrc/
deform_mlp.cu) against the repo's build on the card, at chip_smoke.py's
bench network (DeformNetwork 8x256, seed 0) and rows (131072, in_dim 84):
each build held against deform_mlp_plain (MLP_TOL of each head's scale,
relaunched bit for bit), then timed with the cuBLAS bf16 chain and its
bare products as medians of interleaved queued rounds
(chip_smoke.repeated_ms), one JSON line each.

    python tools/mlp_variants.py [--parent OLD.cu] [--variants JSON]
                                 [--sources NAME=PATH ...] [--rows N ...]

--parent times an earlier source of the kernel with the first, wmma
design's C interface (e.g. the parent commit's, unpacked with git
archive) as "parent"; --variants (JSON text, or a file holding it) maps
a name to a list of [old, new] text substitutions in the repo's source,
each built as its own variant with the repo's interface; --sources
builds other files with the repo's interface (e.g. an earlier draft of
the current design).
A variant named probe_* computes something else on purpose (e.g. the
weight stream without the products): its error is reported, not held.
Builds go to trase_tpu_torch/build/variants/.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from trase_tpu_torch.ops import cuda_lib as CL  # noqa: E402
from trase_tpu_torch.ops import mlp_cuda as M  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="{}")
    ap.add_argument("--sources", nargs="*", default=[])
    ap.add_argument("--rows", type=int, nargs="*", default=[CS.CAPACITY])
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(CS.nvidia_smi(), flush=True)
    with open(CL.SOURCES["deform_mlp"]) as f:
        src = f.read()
    builds = {}
    if a.parent:
        with open(a.parent) as f:
            builds["parent"] = CS.start_nvcc("parent", f.read())
    for item in a.sources:
        name, path = item.split("=", 1)
        with open(path) as f:
            builds[name] = CS.start_nvcc(name, f.read())
    spec = a.variants
    if os.path.exists(spec):
        with open(spec) as f:
            spec = f.read()
    for name, subs in json.loads(spec).items():
        s = src
        for old, new in subs:
            assert old in s, old
            s = s.replace(old, new)
        builds[name] = CS.start_nvcc(name, s)
    path, _, log = CL.build_library(["deform_mlp"])["deform_mlp"]
    CS.emit({"variant": "repo", "ptxas": [
        ln.strip() for ln in log.splitlines()
        if any(w in ln for w in ("registers", "spill", "wgmma",
                                 "setmaxnreg"))], "res_usage":
        CS.res_usage(path)})
    libs = {"repo": CL.library("deform_mlp", M.SIGNATURES)}
    for name, b in builds.items():
        lib, so, lines = CS.finish_nvcc(b, {
            "trase_deform_mlp": CS.PARENT_MLP_ARGTYPES} if name == "parent"
            else M.SIGNATURES)
        CS.emit({"variant": name, "ptxas": lines,
                 "res_usage": CS.res_usage(so) if lib else None})
        if lib is not None:
            libs[name] = lib

    from trase_tpu_torch.models.deform import (frequency_embed, init_deform,
                                               make_deform_network)

    net = init_deform(make_deform_network("DeformNetwork", device=dev),
                      torch.Generator().manual_seed(0))
    net.eval()
    w = M.pack_fused_weights(net)
    dw = M.device_layout(w)
    rng = np.random.default_rng(0)
    try:
        for n in a.rows:
            pts = (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)
            pts[:, 2] += 4.0
            xyz = torch.tensor(pts, device=dev)
            t = torch.full((n, 1), 0.5, device=dev)
            emb = torch.cat([frequency_embed(xyz, net.multires),
                             frequency_embed(t, net.t_multires)], 1)
            ref = M.deform_mlp_plain(w, emb)
            fns, errs = {}, {}
            for name, lib in libs.items():
                if name == "parent":
                    def fn(lib=lib):
                        return CS.parent_mlp(lib, w, emb)
                else:
                    def fn(lib=lib):
                        CL.LIBS["deform_mlp"] = lib
                        return M.deform_mlp_cuda(dw, emb)
                got, again = fn(), fn()
                torch.cuda.synchronize()
                errs[name] = dict(
                    CS.mlp_rel(got, ref),
                    relaunch_identical=all(torch.equal(x, y)
                                           for x, y in zip(got, again)))
                fns[name] = fn
            chain = CS.cublas_chain(w)
            with torch.no_grad():
                bf = torch.bfloat16
                h = torch.ones((n, 256), dtype=bf, device=dev)
                ins = ([emb.to(bf)] + [h] * 4
                       + [torch.ones((n, w.in_dim + 256), dtype=bf,
                                     device=dev)] + [h] * 2 + [h.float()])
                fns["library"] = lambda: chain(emb)
                fns["library_gemms"] = lambda: chain.gemms(ins)
                reps = CS.repeated_ms(fns)
            CS.emit({"rows": n, "errors": errs,
                     "median": {k: v["median"] for k, v in reps.items()},
                     "range": {k: [v["min"], v["max"]]
                               for k, v in reps.items()},
                     **CS.mlp_bound(n, w.in_dim, w.w0.shape[1])})
            bad = {k: e for k, e in errs.items() if not k.startswith("probe_")
                   and (max(v for h, v in e.items() if h in CS.MLP_HEADS)
                        > CS.MLP_TOL or not e["relaunch_identical"])}
            assert not bad, f"builds disagree with plain: {bad}"
    finally:
        CL.LIBS["deform_mlp"] = libs["repo"]


if __name__ == "__main__":
    main()
