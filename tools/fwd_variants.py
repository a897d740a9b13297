"""Times variants of the compositor forward (trase_tpu_torch/csrc/
composite_fwd.cu) against the repo's build on the card, at chip_smoke.py's
bench scene: each variant's instantiations held bit for bit against
composite_plain, then timed as medians of interleaved queued rounds
(chip_smoke.repeated_ms), one JSON line per layout.

    python tools/fwd_variants.py [--parent OLD.cu] [--variants JSON]

--parent times another source of the kernel (e.g. the parent commit's,
unpacked with git archive) as variant "parent"; --variants maps a name to
a list of [old, new] text substitutions in the repo's source, each built
as its own variant. Builds go to trase_tpu_torch/build/variants/.
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
from trase_tpu_torch.ops import rasterize_cuda as RC  # noqa: E402
from trase_tpu_torch.ops.rasterize import RasterConfig  # noqa: E402

# (residuals, with_color, with the 32 features, packed): the launched
# layouts first
LAYOUTS = ((False, True, False, False), (True, True, False, False),
           (False, True, True, False), (False, True, True, True),
           (False, False, True, False), (False, False, True, True),
           (True, False, True, False), (True, False, True, True))


def build_variants(sources: dict) -> dict:
    """{name: ctypes library} of each source, built in parallel."""
    builds = {name: CS.start_nvcc(name, src) for name, src in sources.items()}
    libs = {}
    for name, b in builds.items():
        lib, so, lines = CS.finish_nvcc(b, RC.FWD_SIGNATURES)
        CS.emit({"variant": name, "built": lib is not None, "ptxas": lines})
        if lib is None:
            continue
        CS.emit({"variant": name, "sass": {
            "/".join(str(int(x)) for x in k): v
            for k, v in sorted(CS.fwd_sass(so, save=False).items())}})
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="{}")
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(CS.nvidia_smi(), flush=True)
    libs = CL.build_library()
    sass = CS.fwd_sass(libs["composite_fwd"][0])
    CS.emit({"fwd-sass": {"/".join(str(int(x)) for x in k): v
                          for k, v in sorted(sass.items())}})
    with open(CL.SOURCES["composite_fwd"]) as f:
        src = f.read()
    sources = {}
    if a.parent:
        with open(a.parent) as f:
            sources["parent"] = f.read()
    for name, subs in json.loads(a.variants).items():
        s = src
        for old, new in subs:
            assert old in s, old
            s = s.replace(old, new)
        sources[name] = s
    vlibs = {"repo": CL.library("composite_fwd", RC.FWD_SIGNATURES),
             **build_variants(sources)}

    from trase_tpu_torch.models import gaussians as G
    from trase_tpu_torch.models.deform import init_deform, make_deform_network
    from trase_tpu_torch.renderer import make_render_camera

    n, cap, H, W = CS.N_GAUSSIANS, CS.CAPACITY, CS.HEIGHT, CS.WIDTH
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(n, 3)) * 1.2).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    params, aux = G.from_point_cloud(pts, cols, sh_degree=3, capacity=cap,
                                     dist2=np.full(n, 0.0004, np.float32),
                                     device=dev)
    cam = make_render_camera(np.eye(3), np.zeros(3), 1.2, 0.95, H, W,
                             device=dev)
    net = init_deform(make_deform_network("DeformNetwork", device=dev),
                      torch.Generator().manual_seed(0))
    net.eval()
    cfg = RasterConfig(pairs_per_gaussian=6)
    try:
        with torch.no_grad():
            proj, feats = CS.projected(params, aux, cam,
                                       CS.deltas(params, net, 0.5), True)
            for res, color, with_feats, pack in LAYOUTS:
                args = CS.kernel_inputs(proj, feats if with_feats else None,
                                        H, W, cfg, pack, color)
                kw = dict(with_color=color, residuals=res)
                ref = RC.composite_plain(*args[:3], H, W, *args[3:], **kw)
                fns, errs = {}, {}
                for name, lib in vlibs.items():
                    def fn(lib=lib):
                        CL.LIBS["composite_fwd"] = lib
                        return RC.composite_fwd(*args[:3], H, W, *args[3:],
                                                **kw)
                    got = fn()
                    torch.cuda.synchronize()
                    pairs = zip(got, ref) if res else [(got, ref)]
                    errs[name] = [float((x.float() - y.float()).abs().max())
                                  for x, y in pairs]
                    fns[name] = fn
                t = CS.repeated_ms(fns)
                CS.emit({"layout": [args[3], args[4], color, res],
                         "max_abs_diff": errs,
                         "median": {k: v["median"] for k, v in t.items()},
                         "range": {k: [v["min"], v["max"]]
                                   for k, v in t.items()}})
                bad = {k: e for k, e in errs.items() if any(e)}
                assert not bad, f"variants disagree with plain: {bad}"
    finally:
        CL.LIBS["composite_fwd"] = vlibs["repo"]


if __name__ == "__main__":
    main()
