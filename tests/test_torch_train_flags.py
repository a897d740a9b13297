"""The port's train CLI against the root train.py: the same flags with the
same defaults (root's parser captured as it parses, train.py untouched),
a named error for each flag whose feature is not ported yet, the run-state
flags (--checkpoint_iterations, --start_checkpoint, --load_iteration,
--profile_iters) at work, both CLIs run on one synthetic dataset with
--no-pack_features and --test_iterations, --load_iteration in both CLIs,
and the port's ``Trainer.evaluate`` against trase_tpu's on the same
parameters (carried across as numpy)."""
import argparse
import json
import os
import re
import shutil
import sys

import numpy as np
import jax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from trase_tpu_torch import train as t_train

torch.set_num_threads(2)

EVAL_LINE = re.compile(
    r"\[ITER (\d+)\] Evaluating (test|train): L1 ([0-9.]+) PSNR ([0-9.inf]+)")


class _Parsed(Exception):
    """Raised in place of parse_args, to capture the root CLI's parser."""


def _root_parser(monkeypatch):
    import train as root_train

    box = {}

    def capture(self, *a, **kw):
        box["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        root_train.main(["-s", "unused"])
    monkeypatch.undo()
    return box["parser"]


def _options(parser) -> dict:
    return {opt: a for a in parser._actions for opt in a.option_strings
            if opt not in ("-h", "--help")}


def test_every_root_flag_with_its_default(monkeypatch):
    """Each option of the root train.py is an option of the port's, with
    the same destination, default, arity, type and choices; the port adds
    --device alone. The one default that names a device differs:
    --data_device is "tpu" in trase_tpu, "cuda" in the port."""
    root = _options(_root_parser(monkeypatch))
    port = _options(t_train.make_parser())
    assert set(port) - set(root) == {"--device"}
    assert not set(root) - set(port)
    for opt, a in root.items():
        b = port[opt]
        want = a.default
        if opt == "--data_device":
            assert want == "tpu"
            want = "cuda"
        assert (b.dest, b.default, b.nargs, b.type, b.choices,
                b.const) == (a.dest, want, a.nargs, a.type, a.choices,
                             a.const), opt


def test_root_command_line_parses():
    """A root command line, with the not-ported flags at their defaults,
    parses; save and test iterations default as in the root CLI."""
    args = t_train.parse_args([
        "-s", "data", "-m", "model", "--iterations", "40000", "--ip",
        "0.0.0.0", "--port", "7000", "--debug_from", "5", "--detect_anomaly",
        "--max_per_tile", "256", "--no-pack_features", "--mesh", "0",
        "--load_iteration", "-1", "--test_iterations", "7", "--quiet"])
    assert args.save_iterations == [1000, 7000, 30000, 60000, 40000]
    assert args.test_iterations == [7]
    assert (args.pack_features, args.max_per_tile) == (False, 256)
    defaults = t_train.parse_args(["-s", "data"])
    assert defaults.test_iterations == [1000, 7000, 30000]
    assert defaults.pack_features is True and defaults.device == "cuda"


@pytest.mark.parametrize("argv,said", [
    (["--mesh_backend", "dense"],
     ["--mesh_backend dense is not ported", "not to port"]),
    (["--mesh", "3", "--device", "cuda"],
     ["--mesh 3", "needs 3 devices", "this machine has 0"]),
], ids=lambda x: x[0].lstrip("-") if isinstance(x, list) else None)
def test_not_ported_flags_raise(argv, said, capsys):
    """What --mesh cannot run exits with argparse's code 2 and says why:
    trase_tpu's dense backend (on ROADMAP.md's not-to-port list), and a
    world of more ranks than the machine has cards (here none)."""
    if "--device" in argv and torch.cuda.is_available():
        pytest.skip("the device-count case needs a machine without a GPU")
    with pytest.raises(SystemExit) as e:
        t_train.parse_args(["-s", "data"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert all(s in err for s in said), err


@pytest.mark.parametrize("start,stop", [(3, 3), (5, 2)])
def test_profile_iters_stop_after_start(start, stop, capsys):
    """--profile_iters STOP <= START exits with argparse's code 2, as the
    root CLI does (train.py:67-68)."""
    with pytest.raises(SystemExit) as e:
        t_train.parse_args(["-s", "data", "--profile_iters", str(start),
                            str(stop)])
    assert e.value.code == 2
    assert "STOP must be > START" in capsys.readouterr().err


# both phases in 6 iterations: FEATURE blocks from 3, a densify at 4
RUN_STATE_FLAGS = ["--iterations", "6", "--is_blender", "--eval",
                   "--sh_degree", "1", "--quiet", "--device", "cpu",
                   "--warm_up", "2", "--warm_up_3d_features", "3",
                   "--iterative_opt_interval", "1", "--densify_from_iter",
                   "2", "--densification_interval", "2",
                   "--densify_until_iter", "5", "--num_sampled_pixels", "64",
                   "--num_sampled_masks", "3", "--pairs_per_gaussian", "16",
                   "--test_iterations", "6", "--save_iterations", "3"]


@pytest.fixture(scope="module")
def run_state(tmp_path_factory):
    """The port's CLI on the CPU: run a to 6 with a checkpoint at 3 and a
    trace of iterations 4-5; run b resumed from a's chkpnt3.pkl; run c
    from the snapshot at 3 of a copy of a's model (--load_iteration 3)."""
    import contextlib
    import io

    from trase_tpu_torch.data.synthetic import write_synthetic_dataset
    from trase_tpu_torch.engine import trainer as TT

    base = tmp_path_factory.mktemp("run_state")
    src = str(base / "data")
    write_synthetic_dataset(src, n_train=3, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24, device="cpu")
    runs = {}
    a, b, c = (str(base / n) for n in "abc")
    for name, mdl, extra in (
            ("a", a, ["--checkpoint_iterations", "3",
                      "--profile_iters", "3", "5"]),
            ("b", b, ["--start_checkpoint",
                      os.path.join(a, "chkpnt3.pkl")]),
            ("c", c, ["--load_iteration", "3"])):
        if name == "c":
            shutil.copytree(a, c)
        with contextlib.redirect_stdout(io.StringIO()):
            tr = t_train.main(["-s", src, "-m", mdl] + RUN_STATE_FLAGS
                              + extra)
        runs[name] = (mdl, tr, TT.train_state_to_numpy(tr.state))
    return runs


@pytest.mark.parametrize("flag", ["checkpoint_iterations", "start_checkpoint",
                                  "load_iteration", "profile_iters"])
def test_run_state_flags_work(run_state, flag):
    """Each run-state flag of the root CLI now works in the port's:
    --checkpoint_iterations writes chkpnt3.pkl; --start_checkpoint resumes
    from it to the uninterrupted run's state bit for bit (CPU);
    --load_iteration 3 trains iterations 4-6 from the snapshot at 3;
    --profile_iters 3 5 writes a Chrome trace of iterations 4-5."""
    from trase_tpu_torch.models.gaussians_io import load_checkpoint

    (a, tra, sa), (b, trb, sb), (c, trc, _) = (run_state[k] for k in "abc")
    if flag == "checkpoint_iterations":
        payload = load_checkpoint(os.path.join(a, "chkpnt3.pkl"))
        assert payload["iteration"] == 3 and payload["schema"]
        assert not os.path.exists(os.path.join(b, "chkpnt3.pkl"))
    elif flag == "start_checkpoint":
        assert trb.step_calls + trb.feature_calls == 3
        assert trb.feature_calls > 0
        for part in ("params", "aux", "opt"):
            for field, x in sa[part].items():
                y = sb[part][field]
                for k in (x if isinstance(x, dict) else {"": x}):
                    np.testing.assert_array_equal(
                        x[k] if k else x, y[k] if k else y,
                        err_msg=f"{part}.{field}.{k}")
    elif flag == "load_iteration":
        assert trc.step_calls + trc.feature_calls == 3
        assert os.path.exists(os.path.join(c, "point_cloud", "iteration_6",
                                           "point_cloud.ply"))
    else:
        path = os.path.join(a, "trace", "trace_3_5.json")
        assert tra.profile_trace == path
        with open(path) as f:
            trace = json.load(f)
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any("aten::" in n for n in names)
        assert trb.profile_trace is None


def test_profile_trace_carries_spans(run_state):
    """--profile_iters turns the port's spans on for its window: the
    trace of iterations 4-5 holds each iteration's trase.iteration and
    trase.step as user annotations, and spans are off again after it."""
    from trase_tpu_torch.utils import trace

    with open(run_state["a"][1].profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("trase.iteration") == names.count("trase.step") == 2
    assert "trase.render.composite" in names
    assert not trace.enabled() and trace.take() == []


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    """The root and the port's train CLI on one synthetic dataset, 6
    iterations, evaluating at 3 and 6 and saving at 3, features unpacked;
    the printed lines of each."""
    import contextlib
    import io

    import train as root_train
    from trase_tpu.data.synthetic import write_synthetic_dataset

    base = tmp_path_factory.mktemp("flags")
    src = str(base / "data")
    write_synthetic_dataset(src, n_train=3, n_test=2, image_size=32,
                            n_blobs=2, pts_per_blob=24)
    common = ["-s", src, "--iterations", "6", "--is_blender", "--eval",
              "--sh_degree", "1", "--quiet", "--no-pack_features",
              "--max_per_tile", "256", "--pairs_per_gaussian", "16",
              "--test_iterations", "3", "6", "--save_iterations", "3"]
    out = {}
    for name, cli, extra in (("root", root_train, []),
                             ("port", t_train, ["--device", "cpu"])):
        mdl = str(base / name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = cli.main(common + ["-m", mdl] + extra)
        out[name] = (mdl, buf.getvalue(), result)
    return out


def test_both_clis_evaluate_and_save(both_clis):
    """Both CLIs print an evaluation of each split at each test iteration
    and the best test PSNR; the port writes its snapshots at 3 and 6, and
    its rasterizer got --no-pack_features, and --max_per_tile, which the
    tiled compositor has no use for, went nowhere."""
    for name, (mdl, text, _) in both_clis.items():
        lines = [m.groups()[:2] for m in EVAL_LINE.finditer(text)]
        assert lines == [("3", "test"), ("3", "train"), ("6", "test"),
                         ("6", "train")], (name, text)
        assert re.search(r"Best PSNR = [0-9.]+ in Iteration [36]", text), name
        for it in (3, 6):
            assert os.path.exists(os.path.join(
                mdl, "point_cloud", f"iteration_{it}", "point_cloud.ply"))
    _, text, trainer = both_clis["port"]
    assert trainer.raster_cfg.pack_features is False
    assert "max_per_tile" not in trainer.raster_cfg._fields
    best = max(float(m.group(4)) for m in EVAL_LINE.finditer(text)
               if m.group(2) == "test")
    assert trainer.best_psnr == pytest.approx(best, abs=1e-3)


def test_load_iteration_matches_trase_tpu(both_clis, monkeypatch,
                                         tmp_path):
    """--load_iteration 6 on copies of the root CLI's model directory, in
    both CLIs: each trainer starts at iteration 6 from the snapshot's
    gaussians (the same values in both packages) and from the deform
    net's init, as a fresh run's, not from deform/iteration_6/deform.pkl
    (trase_tpu's behaviour, kept: ROADMAP.md, Queue 3): the copies'
    deform.pkl at 6 is replaced by weights 1 away from the init, which
    neither trainer takes. Trainers are captured as train() is called,
    which then returns."""
    import contextlib
    import io

    import jax
    import train as root_train
    import trase_tpu.engine.loop as JL
    from trase_tpu.models import gaussians_io as JIO
    from trase_tpu_torch.engine import loop as TL

    captured = []

    def capture(self, first_iter=0, **kw):
        captured.append((self, first_iter))

    monkeypatch.setattr(JL.Trainer, "train", capture)
    monkeypatch.setattr(TL.Trainer, "train", capture)
    root_mdl = both_clis["root"][0]
    src = os.path.join(os.path.dirname(root_mdl), "data")
    common = ["-s", src, "--iterations", "8", "--is_blender", "--eval",
              "--sh_degree", "1", "--quiet", "--pairs_per_gaussian", "16"]
    deform_pkl = os.path.join("deform", "iteration_6", "deform.pkl")
    payload = JIO.load_checkpoint(os.path.join(root_mdl, deform_pkl))
    saved = jax.tree_util.tree_map(lambda x: np.asarray(x) + 1.0,
                                   payload["vars"])["params"]
    got = {}
    for name, cli, extra in (("root", root_train, []),
                             ("port", t_train, ["--device", "cpu"])):
        for load in (True, False):
            mdl = str(tmp_path / f"{name}_{load}")
            shutil.copytree(root_mdl, mdl)
            JIO.save_checkpoint(os.path.join(mdl, deform_pkl), dict(
                payload, vars={"params": saved}))
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(common + ["-m", mdl] + extra
                         + (["--load_iteration", "6"] if load else []))
            got[name, load] = captured.pop()
    ply = os.path.join(root_mdl, "point_cloud", "iteration_6",
                       "point_cloud.ply")
    jparams, _, n, _ = JIO.load_gaussian_ply(ply, sh_degree=1)
    for name in ("root", "port"):
        (loaded, first), (fresh, first0) = got[name, True], got[name, False]
        assert (first, first0) == (6, 0), name
        if name == "root":
            p = jax.tree_util.tree_map(np.asarray, loaded.state.params)
            dv = jax.tree_util.tree_map(np.asarray,
                                        loaded.state.deform_vars)["params"]
            dv0 = jax.tree_util.tree_map(np.asarray,
                                         fresh.state.deform_vars)["params"]
        else:
            p = {k: v.numpy() for k, v in
                 loaded.state.params._asdict().items()}
            dv = loaded.deform_variables()["params"]
            dv0 = fresh.deform_variables()["params"]
            p = type(jparams)(**p)
        for field in ("xyz", "features_dc", "features_rest", "opacity",
                      "scaling", "rotation", "gaussian_features"):
            np.testing.assert_array_equal(
                np.asarray(getattr(p, field))[:n],
                np.asarray(getattr(jparams, field))[:n],
                err_msg=(name, field))
        for layer in saved:
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(dv[layer][k], dv0[layer][k])
                assert not np.array_equal(dv[layer][k], saved[layer][k])


def test_evaluate_matches_trase_tpu(both_clis, monkeypatch):
    """The port's evaluate on trase_tpu's trained parameters and deform
    weights, carried across as numpy, prints the same L1 and PSNR for
    each split as trase_tpu's evaluate (its renderer through the Pallas
    kernel in interpret mode; both scenes unshuffled, so that both pick
    the same views): PSNR within 1e-3 dB."""
    import contextlib
    import io

    import trase_tpu.renderer as JR
    from trase_tpu.data.scene import Scene as JScene
    from trase_tpu.engine.loop import Trainer as JTrainer
    from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
    from trase_tpu_torch.data.scene import Scene as TScene
    from trase_tpu_torch.engine import trainer as TT
    from trase_tpu_torch.engine.loop import Trainer as TTrainer
    from trase_tpu_torch.models import deform as TD
    from trase_tpu_torch.models import gaussians as TG
    from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig

    monkeypatch.setattr(JR, "default_backend", lambda: "pallas_interpret")
    mdl = both_clis["root"][0]
    args = t_train.parse_args(["-s", os.path.dirname(mdl) + "/data", "-m",
                               mdl, "--is_blender", "--eval",
                               "--sh_degree", "1"])
    from trase_tpu.config import ModelParams as JMP
    from trase_tpu.config import OptimizationParams as JOP
    from trase_tpu_torch.config import ModelParams as TMP
    from trase_tpu_torch.config import OptimizationParams as TOP

    jtr = JTrainer(JMP.extract(args), JOP.extract(args), None,
                   JScene(JMP.extract(args), shuffle=False),
                   raster_cfg=JRasterConfig(pairs_per_gaussian=16))
    jstate = jtr.state
    rng = np.random.default_rng(3)
    jp = jstate.params
    jp = jp._replace(
        xyz=np.asarray(jp.xyz) + rng.normal(scale=0.02, size=jp.xyz.shape),
        features_dc=np.asarray(jp.features_dc) + rng.normal(
            scale=0.2, size=jp.features_dc.shape))
    jp = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp)
    jtr.state = jstate._replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, jp))
    jtr.active_sh_degree = 1

    ttr = TTrainer(TMP.extract(args), TOP.extract(args), None,
                   TScene(TMP.extract(args), shuffle=False, device="cpu"),
                   raster_cfg=TRasterConfig(pairs_per_gaussian=16),
                   device="cpu")
    params, aux = TG.params_from_numpy(jp, jax.tree_util.tree_map(
        np.asarray, jstate.aux), device="cpu")
    TD.load_flax_params(ttr.deform_net, jax.tree_util.tree_map(
        np.asarray, jstate.deform_vars))
    ttr.state = ttr.state._replace(params=params, aux=aux,
                                   deform=TT.deform_tensors(ttr.deform_net))
    ttr.active_sh_degree = 1

    got = {}
    for name, tr in (("trase_tpu", jtr), ("port", ttr)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            test_psnr = tr.evaluate(9)
        got[name] = (test_psnr, [m.groups() for m in
                                 EVAL_LINE.finditer(buf.getvalue())])
    (jt, jl), (tt, tl) = got["trase_tpu"], got["port"]
    assert [x[:2] for x in tl] == [x[:2] for x in jl] == [
        ("9", "test"), ("9", "train")]
    assert abs(tt - jt) <= 1e-3 and 10.0 < jt < 60.0
    # the printed values, rounded to 3 (PSNR) and 6 (L1) decimals: the
    # tolerance plus one unit of the last printed place
    for (_, _, jl1, jpsnr), (_, _, tl1, tpsnr) in zip(jl, tl):
        assert abs(float(tpsnr) - float(jpsnr)) <= 2e-3
        assert abs(float(tl1) - float(jl1)) <= 2e-6
