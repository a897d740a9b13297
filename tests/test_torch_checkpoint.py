"""The port's run state (trase_tpu_torch/engine/loop.py: save_ckpt /
load_ckpt / load_reference_ckpt, models/gaussians_io.py, tools/
import_torch.py, TensorBoardLogger) on the CPU: its own checkpoints bit
for bit, the keyed schema's refusals, trase_tpu's chkpnt<N>.pkl read
with jax, flax and trase_tpu blocked from import, the reference's .pth
files through both importers bit for bit, TensorBoard's tags, and writes
that leave the earlier file intact when they fail."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from trase_tpu_torch import train as t_train
from trase_tpu_torch.config import ModelParams as TMP
from trase_tpu_torch.config import OptimizationParams as TOP
from trase_tpu_torch.data.scene import Scene as TScene
from trase_tpu_torch.data.synthetic import write_synthetic_dataset
from trase_tpu_torch.engine import trainer as TT
from trase_tpu_torch.engine.loop import Trainer as TTrainer
from trase_tpu_torch.models import gaussians_io as TIO
from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# both phases inside 10 iterations: deform from 3, FEATURE blocks from 4
# every 3 counted steps, a densify at 5 and 8 (with capacity growth)
RUN_FLAGS = ["--is_blender", "--eval", "--sh_degree", "1", "--iterations",
             "10", "--warm_up", "3", "--warm_up_3d_features", "4",
             "--iterative_opt_interval", "2", "--densify_from_iter", "2",
             "--densification_interval", "3", "--densify_until_iter", "9",
             "--num_sampled_pixels", "64", "--num_sampled_masks", "3",
             "--pairs_per_gaussian", "16"]
# trase_tpu's TensorBoard tags (trase_tpu/engine/loop.py:408-409,
# :683-690, :754-763)
TRASE_TPU_TAGS = {"overflow/dropped_pairs", "train_loss_patches/l1_loss",
                  "train_loss_patches/total_loss", "iter_time",
                  "test/loss_viewpoint - l1_loss",
                  "test/loss_viewpoint - psnr",
                  "train/loss_viewpoint - l1_loss",
                  "train/loss_viewpoint - psnr", "total_points"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("ckpt") / "data")
    write_synthetic_dataset(src, n_train=3, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24, device="cpu")
    return src


def _trainer(src, mdl, extra=()):
    """A port Trainer on the CPU over an unshuffled scene."""
    args = t_train.parse_args(["-s", src, "-m", mdl] + RUN_FLAGS
                              + list(extra))
    ds = TMP.extract(args)
    os.makedirs(mdl, exist_ok=True)
    return TTrainer(ds, TOP.extract(args), None,
                    TScene(ds, shuffle=False, device="cpu"),
                    raster_cfg=TRasterConfig(pairs_per_gaussian=16),
                    device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_state_equal(a: dict, b: dict):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _run_state(tr) -> dict:
    """Everything a resume restores besides the state tensors."""
    return {"sh": tr.active_sh_degree,
            "phase": (tr.opt_state.state, tr.opt_state.iterations),
            "np_rng": tr.np_rng.bit_generator.state,
            "densify_gen": tr.densify_gen.get_state().numpy().tobytes(),
            "feature_gen": tr.feature_gen.get_state().numpy().tobytes(),
            "skipped": (int(tr.skipped), tr._skipped_seen),
            "stack": [c.image_name for c in tr._viewpoint_stack],
            "next": None if tr._next_cam is None else tr._next_cam.image_name}


@pytest.fixture(scope="module")
def uninterrupted(data_dir, tmp_path_factory):
    """A 10-iteration run that writes chkpnt5.pkl; the live state and run
    state at 5 (after the save) and at 10."""
    mdl = str(tmp_path_factory.mktemp("ckpt") / "run")
    tr = _trainer(data_dir, mdl)
    seen = {}

    def hook(t, iteration, metrics):
        if iteration == 5:
            seen["state"] = TT.train_state_to_numpy(t.state)
            seen["run"] = _run_state(t)

    tr.train(checkpoint_iterations={5}, progress=False, on_iteration=hook)
    seen["final"] = TT.train_state_to_numpy(tr.state)
    seen["feature_calls"] = tr.feature_calls
    return os.path.join(mdl, "chkpnt5.pkl"), seen


def test_checkpoint_roundtrip(data_dir, uninterrupted, tmp_path):
    """load_ckpt restores the state, Adam moments, SH degree, phase
    machine, generator states, skipped-step counters and view stack as
    they were when save_ckpt wrote them, bit for bit; the file pickles
    no class of the port."""
    ck, seen = uninterrupted
    assert seen["feature_calls"] > 0  # the run reached FEATURE blocks
    tr = _trainer(data_dir, str(tmp_path / "m"))
    assert tr.load_ckpt(ck) == 5
    _assert_state_equal(TT.train_state_to_numpy(tr.state), seen["state"])
    assert _run_state(tr) == seen["run"]
    assert tr._smooth_dirty
    assert tr._n_alive_cache == int(seen["state"]["aux"]["alive"].sum())

    class Plain(pickle.Unpickler):
        def find_class(self, module, name):
            assert module.split(".")[0] in ("numpy", "builtins"), \
                (module, name)
            return super().find_class(module, name)

    with open(ck, "rb") as f:
        payload = Plain(f).load()
    assert payload["schema"] == TT.state_schema(tr.state)


@pytest.mark.parametrize("change", ["renamed", "dtype", "missing"])
def test_schema_mismatch_refused(data_dir, uninterrupted, tmp_path, change):
    """A checkpoint whose keyed schema names a field this trainer's state
    lacks, changes a dtype or misses a field raises, as trase_tpu's
    load_ckpt does (tests/test_train_loop.py::test_checkpoint_roundtrip)."""
    ck, _ = uninterrupted
    with open(ck, "rb") as f:
        payload = pickle.load(f)
    schema = list(payload["schema"])
    if change == "renamed":
        schema[0] = ("['params']['renamed_field']", schema[0][1])
    elif change == "dtype":
        schema[0] = (schema[0][0], "float16")
    else:
        schema = schema[1:]
    bad = str(tmp_path / "bad.pkl")
    with open(bad, "wb") as f:
        pickle.dump(dict(payload, schema=schema), f)
    tr = _trainer(data_dir, str(tmp_path / "m"))
    with pytest.raises(ValueError, match="schema mismatch"):
        tr.load_ckpt(bad)


def test_resume_equals_uninterrupted_run(data_dir, uninterrupted, tmp_path):
    """On the CPU a run resumed from chkpnt5.pkl reaches the state the
    uninterrupted run reached at 10, bit for bit (across FEATURE blocks,
    densifies and capacity growth)."""
    ck, seen = uninterrupted
    tr = _trainer(data_dir, str(tmp_path / "m"))
    tr.train(first_iter=tr.load_ckpt(ck), progress=False)
    _assert_state_equal(TT.train_state_to_numpy(tr.state), seen["final"])


def test_two_resumes_identical(data_dir, uninterrupted, tmp_path):
    """Two resumes from one checkpoint give identical states after 5 more
    iterations."""
    ck, _ = uninterrupted
    states = []
    for name in ("a", "b"):
        tr = _trainer(data_dir, str(tmp_path / name))
        tr.train(first_iter=tr.load_ckpt(ck), progress=False)
        states.append(TT.train_state_to_numpy(tr.state))
    _assert_state_equal(*states)


def test_trase_tpu_checkpoint_loads_without_jax(tmp_path):
    """trase_tpu's Trainer trains 4 iterations and writes chkpnt4.pkl; the
    port's load_ckpt, in a process where jax, jaxlib, flax and trase_tpu
    cannot be imported, gives train_state_from_numpy of the same state
    bit for bit, with the same SH degree, phase machine and iteration."""
    import jax

    from test_train_loop import _Args, _Opt, _Pipe
    from trase_tpu.data.scene import Scene
    from trase_tpu.data.synthetic import write_synthetic_dataset as jw
    from trase_tpu.engine.loop import Trainer
    from trase_tpu.ops.rasterize import RasterConfig

    src = str(tmp_path / "data")
    jw(src, n_train=3, n_test=1, image_size=32, n_blobs=2, pts_per_blob=24)
    args = _Args(src, str(tmp_path / "jax"))
    opt = _Opt()
    opt.iterations, opt.warm_up, opt.densify_until_iter = 4, 2, 0
    jtr = Trainer(args, opt, _Pipe(), Scene(args, resolution_scales=(1.0,)),
                  raster_cfg=RasterConfig(pairs_per_gaussian=4,
                                          max_per_tile=128, tile_batch=4))
    jtr.train(first_iter=0, checkpoint_iterations={4}, progress=False)
    ck = os.path.join(args.model_path, "chkpnt4.pkl")
    out = str(tmp_path / "loaded.pkl")
    argv = ["-s", src, "-m", str(tmp_path / "port"), "--is_blender",
            "--eval", "--sh_degree", "1"]
    code = (
        "import sys, pickle\n"
        "for m in ('jax', 'jaxlib', 'flax', 'trase_tpu'):\n"
        "    sys.modules[m] = None  # any import of them now fails\n"
        "from trase_tpu_torch import train as t_train\n"
        "from trase_tpu_torch.config import ModelParams, OptimizationParams\n"
        "from trase_tpu_torch.data.scene import Scene\n"
        "from trase_tpu_torch.engine.loop import Trainer\n"
        "from trase_tpu_torch.engine.trainer import train_state_to_numpy\n"
        f"args = t_train.parse_args({argv!r})\n"
        "ds = ModelParams.extract(args)\n"
        "tr = Trainer(ds, OptimizationParams.extract(args), None,\n"
        "             Scene(ds, shuffle=False, device='cpu'), device='cpu')\n"
        f"it = tr.load_ckpt({ck!r})\n"
        "loaded = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "                and m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                        'trase_tpu'))\n"
        f"with open({out!r}, 'wb') as f:\n"
        "    pickle.dump({'state': train_state_to_numpy(tr.state),\n"
        "                 'iteration': it, 'sh': tr.active_sh_degree,\n"
        "                 'phase': (tr.opt_state.state,\n"
        "                           tr.opt_state.iterations),\n"
        "                 'loaded': loaded}, f)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["loaded"] == []
    assert got["iteration"] == 4
    assert got["sh"] == jtr.active_sh_degree
    assert got["phase"] == (jtr.opt_state.state, jtr.opt_state.iterations)
    ref = TT.train_state_to_numpy(TT.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.state), "cpu"))
    _assert_state_equal(got["state"], ref)


@pytest.mark.parametrize("what", ["RasterConfig", "jax array"])
def test_other_trase_tpu_and_jax_classes_refused(tmp_path, what):
    """load_checkpoint maps trase_tpu's checkpoint containers alone and
    refuses any other trase_tpu or jax class by name."""
    import jax.numpy as jnp

    from trase_tpu.ops.rasterize import RasterConfig

    obj = RasterConfig() if what == "RasterConfig" else jnp.ones(3)
    path = str(tmp_path / "x.pkl")
    with open(path, "wb") as f:
        pickle.dump({"state": obj}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        TIO.load_checkpoint(path)


# --------------------------------------------------- the reference's .pth


def _reference_deform_sd(is_blender: bool, rng):
    """A reference DeformNetwork state_dict (utils/time_utils.py:60-132):
    8x256 with the skip after layer 4, blender timenet when asked."""
    W, XF = 256, 10
    TF = 6 if is_blender else 10
    t_ch = 30 if is_blender else 1 + 2 * TF
    in_ch = 3 * (1 + 2 * XF) + t_ch

    def lin(i, o):
        return (torch.tensor(rng.normal(size=(o, i)).astype(np.float32)
                             * 0.05),
                torch.tensor(rng.normal(size=(o,)).astype(np.float32)
                             * 0.05))

    sd = {}
    if is_blender:
        for name, (ci, co) in (("timenet.0", (1 + 2 * TF, W)),
                               ("timenet.2", (W, 30))):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = lin(ci, co)
    dims = [(in_ch, W)] + [(W, W)] * 7
    dims[5] = (W + in_ch, W)
    for i, (ci, co) in enumerate(dims):
        sd[f"linear.{i}.weight"], sd[f"linear.{i}.bias"] = lin(ci, co)
    for name, o in (("gaussian_warp", 3), ("gaussian_rotation", 4),
                    ("gaussian_scaling", 3)):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = lin(W, o)
    return sd


@pytest.mark.parametrize("is_blender", [False, True])
def test_deform_pth_both_importers(tmp_path, is_blender):
    """A reference deform.pth through trase_tpu's and the port's
    import_deform_pth: the same flax-layout weights bit for bit; the
    port's network on them reproduces the reference's forward (numpy,
    interleaved sin/cos embedding) within test_interop.py's tolerance."""
    from trase_tpu.tools import import_torch as JI
    from trase_tpu_torch.models import deform as TD
    from trase_tpu_torch.tools import import_torch as TI

    rng = np.random.default_rng(11)
    sd = _reference_deform_sd(is_blender, rng)
    path = str(tmp_path / "deform.pth")
    torch.save(sd, path)
    jp = JI.import_deform_pth(path, is_blender=is_blender)
    tp = TI.import_deform_pth(path, is_blender=is_blender)
    assert jp["type"] == tp["type"] == "DeformNetwork"
    jl, tl = jp["vars"]["params"], tp["vars"]["params"]
    assert sorted(jl) == sorted(tl)
    for layer in jl:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(tl[layer][k],
                                          np.asarray(jl[layer][k]))
    if is_blender:
        return
    net = TD.load_flax_params(TD.make_deform_network(device="cpu"),
                              tp["vars"])

    def embed(v, f):
        outs = [v]
        for k in range(f):
            outs += [np.sin(v * 2.0 ** k), np.cos(v * 2.0 ** k)]
        return np.concatenate(outs, axis=-1)

    x = rng.normal(size=(64, 3)).astype(np.float32)
    t = rng.uniform(size=(64, 1)).astype(np.float32)
    w = {k: v.numpy() for k, v in sd.items()}
    inp = np.concatenate([embed(x, 10), embed(t, 10)], axis=-1)
    h = inp
    for i in range(8):
        h = np.maximum(h @ w[f"linear.{i}.weight"].T + w[f"linear.{i}.bias"],
                       0.0)
        if i == 4:
            h = np.concatenate([inp, h], axis=-1)
    ref = [h @ w[f"{n}.weight"].T + w[f"{n}.bias"]
           for n in ("gaussian_warp", "gaussian_rotation", "gaussian_scaling")]
    with torch.no_grad():
        ours = TD.deform_step(net, torch.tensor(x), torch.tensor(t))
    for a, b in zip(ref, ours):
        np.testing.assert_allclose(b.numpy(), a, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("opt_shape", ["dual", "single", "none"])
def test_chkpnt_pth_both_importers(tmp_path, opt_shape):
    """A reference chkpnt300.pth (torch.save((capture(), 300))) through
    trase_tpu's and the port's import_chkpnt_pth: params, aux, Adam state
    and meta equal bit for bit, for each optimizer shape found in the
    wild."""
    import jax

    from test_interop import _fake_capture
    from trase_tpu.tools.import_torch import import_chkpnt_pth as j_import
    from trase_tpu_torch.tools.import_torch import import_chkpnt_pth

    path = str(tmp_path / "chkpnt300.pth")
    torch.save((_fake_capture(n=50, opt_shape=opt_shape), 300), path)
    jp, ja, jo, jmeta = j_import(path)
    tp, ta, to, tmeta = import_chkpnt_pth(path, device="cpu")
    assert tmeta == jmeta and tmeta["iteration"] == 300
    for j, t in ((jp, tp), (ja, ta)):
        for name, x in t._asdict().items():
            y = np.asarray(getattr(j, name))
            assert x.numpy().dtype == y.dtype, name
            np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
    for name, s in to._asdict().items():
        js = jax.tree_util.tree_map(np.asarray, getattr(jo, name))
        for k in ("mu", "nu", "step"):
            np.testing.assert_array_equal(getattr(s, k).numpy(),
                                          getattr(js, k), err_msg=(name, k))


def test_trainer_resumes_from_reference_pth(data_dir, tmp_path):
    """--start_checkpoint chkpnt300.pth: the port's trainer takes the
    imported field (its deform net stays as it was: the file has none)
    and trains on from 300 with finite losses."""
    from test_interop import _fake_capture
    from trase_tpu_torch.tools.import_torch import import_chkpnt_pth

    path = str(tmp_path / "chkpnt300.pth")
    torch.save((_fake_capture(n=40, opt_shape="dual"), 300), path)
    tr = _trainer(data_dir, str(tmp_path / "m"), ["--iterations", "304"])
    deform = [t.clone() for t in tr.state.deform]
    assert tr.load_ckpt(path) == 300
    assert tr.active_sh_degree == 1 and tr._n_alive_cache == 40
    params = import_chkpnt_pth(path, device="cpu")[0]
    for name, x in params._asdict().items():
        assert torch.equal(getattr(tr.state.params, name), x), name
    assert all(torch.equal(a, b) for a, b in zip(tr.state.deform, deform))
    losses = []
    tr.train(first_iter=300, progress=False,
             on_iteration=lambda t, i, m: losses.append(float(m["loss"])))
    assert len(losses) == 4 and np.isfinite(losses).all()


def test_converter_writes_port_formats(tmp_path):
    """python -m trase_tpu_torch.tools.import_torch: a chkpnt.pth becomes
    a pickle of numpy dicts, a deform.pth the deform.pkl payload the port
    and trase_tpu read."""
    from test_interop import _fake_capture
    from trase_tpu_torch.models import deform as TD
    from trase_tpu_torch.tools import import_torch as TI

    pth = str(tmp_path / "chkpnt7.pth")
    torch.save((_fake_capture(n=30), 7), pth)
    out = str(tmp_path / "out" / "chkpnt7.pkl")
    TI.main(["--kind", "chkpnt", "-i", pth, "-o", out, "--device", "cpu"])
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["meta"]["iteration"] == 7 and got["meta"]["n_alive"] == 30
    assert isinstance(got["params"]["xyz"], np.ndarray)
    assert isinstance(got["opt"]["xyz"]["mu"], np.ndarray)
    dpth = str(tmp_path / "deform.pth")
    torch.save(_reference_deform_sd(False, np.random.default_rng(2)), dpth)
    dout = str(tmp_path / "deform.pkl")
    TI.main(["-i", dpth, "-o", dout])
    payload = TIO.load_checkpoint(dout)
    assert payload["type"] == "DeformNetwork"
    TD.load_flax_params(TD.make_deform_network(device="cpu"),
                        payload["vars"])


# ------------------------------------------------------------ TensorBoard


def test_tensorboard_scalars_under_trase_tpu_tags(data_dir, tmp_path):
    """With tensorboard installed, the trainer writes an event file under
    its model path: the loss and iteration-time scalars every 10
    iterations, the evaluation's, and total_points, each under one of
    trase_tpu's tags."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    mdl = str(tmp_path / "tb")
    tr = _trainer(data_dir, mdl, ["--iterations", "20",
                                  "--warm_up_3d_features", "100"])
    assert tr.tb.writer is not None
    tr.train(testing_iterations={20}, progress=False)
    tr.tb.close()
    events = [f for f in os.listdir(mdl) if f.startswith("events.out")]
    assert len(events) == 1
    acc = EventAccumulator(mdl)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags <= TRASE_TPU_TAGS
    assert tags == TRASE_TPU_TAGS - {"overflow/dropped_pairs"}
    assert [e.step for e in acc.Scalars(
        "train_loss_patches/total_loss")] == [10, 20]
    assert acc.Scalars("total_points")[0].value == tr._n_alive_cache


def test_tensorboard_logger_imports_no_jax(tmp_path):
    """Building the logger imports tensorboard's TensorFlow-free writer:
    neither TensorFlow nor jax (which TensorFlow would pull in where it
    is installed) is imported."""
    code = (
        "import sys\n"
        "pre = {m for m in ('jax', 'tensorflow') if m in sys.modules}\n"
        "from trase_tpu_torch.engine.loop import TensorBoardLogger\n"
        f"tb = TensorBoardLogger({str(tmp_path)!r})\n"
        "tb.scalar('a/b', 1.0, 1)\n"
        "tb.close()\n"
        "assert tb.writer is not None\n"
        "assert not {'jax', 'tensorflow'} & (set(sys.modules) - pre)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
    assert any(f.startswith("events.out") for f in os.listdir(tmp_path))


# ---------------------------------------------------------- atomic writes


@pytest.mark.parametrize("writer", ["save_checkpoint", "save_gaussian_ply"])
def test_failed_write_leaves_earlier_file(tmp_path, monkeypatch, writer):
    """A write that fails midway leaves the earlier file as it was and no
    temporary file behind."""
    from trase_tpu_torch.models import gaussians as TG

    path = str(tmp_path / ("c.pkl" if writer == "save_checkpoint"
                           else "p.ply"))
    params, aux = TG.from_point_cloud(
        np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32),
        np.full((20, 3), 0.5, np.float32), 1, device="cpu")

    def write():
        if writer == "save_checkpoint":
            TIO.save_checkpoint(path, {"x": params.xyz})
        else:
            TIO.save_gaussian_ply(path, params, aux.alive)

    write()
    with open(path, "rb") as f:
        before = f.read()

    def broken(target, *a, **kw):
        name = target if isinstance(target, str) else target.name
        with open(name, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    if writer == "save_checkpoint":
        monkeypatch.setattr(TIO.pickle, "dump",
                            lambda obj, f: broken(f))
    else:
        monkeypatch.setattr(TIO, "write_ply", broken)
    with pytest.raises(OSError, match="disk full"):
        write()
    with open(path, "rb") as f:
        assert f.read() == before
    assert os.listdir(tmp_path) == [os.path.basename(path)]
