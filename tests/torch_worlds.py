"""Worlds of gloo ranks for the port's multi-device tests, and the rank
functions they run. This module imports torch, numpy and the port only,
never jax or trase_tpu, so the spawned ranks stay light: the tests compute
their JAX references in the parent and pass everything as numpy.

``run_world(fn, size, tmp_dir, inputs)`` spawns `size` ranks with
torch.multiprocessing, each joining a gloo world through a file store of
its own under `tmp_dir`; rank r calls ``fn(world, inputs)`` and its
return value comes back as element r of the result. A rank that fails
fails the call, and a world that does not finish within `timeout`
seconds is killed and raises.
"""
from __future__ import annotations

import os
import pickle
import time
import uuid

import torch
import torch.multiprocessing as mp

from trase_tpu_torch.engine import trainer as T
from trase_tpu_torch.losses.contrastive import PixelSample
from trase_tpu_torch.models import gaussians as G
from trase_tpu_torch.models.deform import make_deform_network
from trase_tpu_torch.ops.rasterize import RasterConfig
from trase_tpu_torch.parallel import sharded as S
from trase_tpu_torch.parallel.world import close_world, init_world
from trase_tpu_torch.renderer import make_render_camera

WORLD_TIMEOUT_S = 120


def _entry(rank, size, store, fn, inputs):
    torch.set_num_threads(1)
    world = init_world(size, rank, "cpu", store_dir=store, timeout_s=60)
    try:
        out = fn(world, inputs)
        with open(os.path.join(store, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        close_world()


def run_world(fn, size: int, tmp_dir, inputs, timeout=WORLD_TIMEOUT_S):
    store = os.path.join(str(tmp_dir), f"world_{uuid.uuid4().hex}")
    os.makedirs(store)
    ctx = mp.start_processes(_entry, args=(size, store, fn, inputs),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {size} ranks ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(size):
        with open(os.path.join(store, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------- inputs


def camera(spec):
    """A CPU RenderCamera from (R, T, fovx, fovy, H, W)."""
    return make_render_camera(*spec, device="cpu")


def net():
    return make_deform_network("DeformNetwork", device="cpu")


def raster_cfg(spec):
    return RasterConfig(**spec)


def lrs(value):
    return T.LearningRates(*[value] * len(T.LearningRates._fields))


def state_from(tree):
    return T.train_state_from_numpy(tree, "cpu")


def numpy_or_none(state):
    return None if state is None else T.train_state_to_numpy(state)


def gathered(state, world):
    """The global state as numpy on rank 0, None on the others."""
    return numpy_or_none(S.unshard_train_state(state, world))


# ----------------------------------------------------- the rank steps


def sharded_steps(world, inp):
    """Every sharded function once from the same global state: the
    render, a GAUSSIAN step, FEATURE steps (smoothed, plain, values-only)
    with the injected sample and slots, then a densify of the GAUSSIAN
    step's state with this rank's injected split samples, and an opacity
    reset. Returns the gathered states and the metrics (rank 0's)."""
    cam = camera(inp["camera"])
    cfg = raster_cfg(inp["raster"])
    state = state_from(inp["state"])
    local = S.shard_train_state(state, world)
    bg = torch.tensor(inp["bg"])
    out = {"render": S.sharded_render_fn(world, inp["sh_degree"], cfg)(
        cam, local.params, local.aux.alive, bg).detach().numpy()}

    step = S.make_sharded_gaussian_step(world, net(), **inp["gauss_kw"],
                                        raster_cfg=cfg)
    new, m = step(local, cam, torch.tensor(inp["gt"]), inp["fid"], 0.0,
                  lrs(inp["lr"]), bg)
    out["gauss"] = (gathered(new, world),
                    {k: v.numpy() for k, v in m.items()})
    after_gauss = new

    masks = torch.tensor(inp["masks"])
    valid = torch.tensor(inp["mask_valid"])
    sample = PixelSample(*[torch.tensor(x) for x in inp["sample"]])
    fstep = S.make_sharded_feature_step(world, net(), **inp["feat_kw"],
                                        raster_cfg=cfg)
    smap = torch.tensor(inp["smooth_map"])
    n = smap.shape[0] // world.size
    smap = smap[world.rank * n:(world.rank + 1) * n]
    for name, smooth, stats in (("smooth", True, True),
                                ("plain", False, True),
                                ("values_only", False, False)):
        new, m = fstep(local, cam, masks, valid, inp["fid"],
                       lrs(inp["lr"]), bg, smap if smooth else None,
                       with_densify_stats=stats, sample=sample,
                       smooth_perm=torch.tensor(inp["smooth_perm"]))
        out[name] = (gathered(new, world),
                     {k: v.numpy() for k, v in m.items()})

    densify = S.make_sharded_densify(
        world, cfg=G.DensifyConfig(**inp["densify_cfg"]),
        max_new_per_shard=inp["max_new_per_shard"])
    new, stats = densify(after_gauss, inp["extent"], 0.0,
                         samples=torch.tensor(
                             inp["split_samples"][world.rank]))
    out["densify"] = (gathered(new, world),
                      {k: int(v) for k, v in stats.items()})
    new = T.reset_opacity_step(after_gauss)  # row-local: on the block
    out["reset"] = gathered(new, world)

    # the rows through rank 0's host: capacity growth grows the gathered
    # state there and sends each rank its block
    glob = S.unshard_train_state(local, world)
    c = local.params.xyz.shape[0] * world.size
    grown = None
    if glob is not None:
        p, a, o = G.grow_capacity(glob.params, glob.aux, glob.opt, 2 * c)
        grown = S.interleave_rows(glob._replace(params=p, aux=a, opt=o),
                                  world.size)
    block = S.scatter_train_state(grown, local, 2 * c, world)
    out["grown"] = (numpy_or_none(grown), gathered(block, world),
                    block.params.xyz.shape[0])
    if world.rank:
        return {"global_state": glob, "block_rows": block.params.xyz.shape[0]}
    return out


# ----------------------------------------------------- the rank loops


def trainer(world, src, mdl, flags, interleave=True):
    """A ShardedTrainer on the CPU (world) or a single-device Trainer
    (world None) over an unshuffled scene of the train CLI's flags."""
    from trase_tpu_torch import train as t_train
    from trase_tpu_torch.config import ModelParams, OptimizationParams
    from trase_tpu_torch.data.scene import Scene
    from trase_tpu_torch.engine.loop import Trainer
    from trase_tpu_torch.parallel.trainer import ShardedTrainer

    args = t_train.parse_args(["-s", src, "-m", mdl] + list(flags))
    ds = ModelParams.extract(args)
    os.makedirs(mdl, exist_ok=True)
    cfg = RasterConfig(pairs_per_gaussian=args.pairs_per_gaussian)
    scene = Scene(ds, shuffle=False, device="cpu")
    if world is None:
        return Trainer(ds, OptimizationParams.extract(args), None, scene,
                       raster_cfg=cfg, device="cpu"), args
    return ShardedTrainer(ds, OptimizationParams.extract(args), None, scene,
                          world, raster_cfg=cfg,
                          interleave_slots=interleave), args


def train_loop(world, inp):
    """Train inp["flags"] (from inp["resume"], a checkpoint, when given),
    recording each iteration's loss and phase; returns them with the
    gathered final state (and, after a resume, the loaded one)."""
    tr, args = trainer(world, inp["src"], inp["mdl"], inp["flags"],
                       inp.get("interleave", True))
    first, loaded = 0, None
    if inp.get("resume"):
        first = tr.load_ckpt(inp["resume"])
        loaded = numpy_or_none(tr.global_state())
    losses, phases = [], []

    def record(t, iteration, metrics):
        losses.append(float(metrics["loss"]))
        phases.append(t.opt_state.state)

    tr.train(first_iter=first, progress=False, on_iteration=record,
             testing_iterations=set(args.test_iterations),
             saving_iterations=set(args.save_iterations),
             checkpoint_iterations=set(args.checkpoint_iterations))
    final = numpy_or_none(tr.global_state())
    if world.rank:
        return None
    return {"losses": losses, "phases": phases, "state": final,
            "loaded": loaded}
