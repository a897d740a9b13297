"""The port's train CLI against the root train.py: the same flags with the
same defaults (root's parser captured as it parses, train.py untouched),
a named error for each flag whose feature is not ported yet, both CLIs
run on one synthetic dataset with --no-pack_features and
--test_iterations, and the port's ``Trainer.evaluate`` against
trase_tpu's on the same parameters (carried across as numpy)."""
import argparse
import os
import re
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


@pytest.mark.parametrize("argv,item", [
    (["--checkpoint_iterations", "5"], "Queue 1 item 2"),
    (["--start_checkpoint", "chkpnt5.pkl"], "Queue 1 item 2"),
    (["--load_iteration", "3"], "Queue 1 item 2"),
    (["--profile_iters", "1", "3"], "Queue 1 item 2"),
    (["--mesh", "2"], "Queue 1 item 13"),
    (["--mesh_backend", "dense"], "Queue 1 item 13"),
], ids=lambda x: x[0].lstrip("-") if isinstance(x, list) else None)
def test_not_ported_flags_raise(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        t_train.parse_args(["-s", "data"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert argv[0] in err and f"ROADMAP.md, {item}" in err


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
    its rasterizer got --no-pack_features and --max_per_tile."""
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
    assert trainer.raster_cfg.max_per_tile == 256
    best = max(float(m.group(4)) for m in EVAL_LINE.finditer(text)
               if m.group(2) == "test")
    assert trainer.best_psnr == pytest.approx(best, abs=1e-3)


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
