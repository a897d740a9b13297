"""Every file of the benchmark is found by name, the names and units keep
to the allowed characters, and BENCHMARK.json agrees with the files."""
import json
import os
import re
import shutil

import pytest

from port_bench import harness as HB

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(HB.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("kind", ["name", "unit"])
def test_names_and_units_use_allowed_characters(kind):
    b = bench()
    items = b["end_to_end"] + b["per_layer"] + b["configs"] + b["workloads"]
    if kind == "name":
        for x in items:
            assert NAME.match(x["name"]), x["name"]
        for w in b["workloads"]:
            assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        for c in b["configs"]:
            assert all(NAME.match(k) for k in c["reduced"])
    else:
        for m in b["end_to_end"] + b["per_layer"]:
            assert UNIT.match(m["unit"]), m["unit"]


def test_every_cell_finds_its_files_by_name():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        wl = HB.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"] == 1
        HB.load_json("configs", wl["config"])
        HB.load_json("traffic", wl["traffic"])
        HB.load_module("modes", wl["mode"])
        for name in wl["per_layer"]:
            reader = HB.load_module("metrics", name)
            assert callable(reader.read)
            assert reader.read(None) is None  # nothing to read: no number
        for m in wl["end_to_end"]:
            assert m["unit"] == e2e[m["name"]]["unit"]
            assert w["name"] in e2e[m["name"]].get("workloads", [w["name"]])
    for c in b["configs"]:
        assert os.path.exists(os.path.join(HB.ROOT, c["file"]))
        assert HB.load_json("configs", c["name"])["name"] == c["name"]


def test_per_layer_metrics_match_the_cells():
    b = bench()
    for m in b["per_layer"]:
        for w in m["workloads"]:
            wl = HB.load_json("workloads", w)
            assert m["name"] in wl["per_layer"]
            assert m["moves"] in [x["name"] for x in wl["end_to_end"]]
            reader = HB.load_module("metrics", m["name"])
            assert reader.UNIT == m["unit"]
    listed = {(m["name"], w) for m in b["per_layer"] for w in m["workloads"]}
    for w in b["workloads"]:
        for name in HB.load_json("workloads", w["name"])["per_layer"]:
            assert (name, w["name"]) in listed


def test_a_file_added_elsewhere_is_found_without_a_code_edit(tmp_path,
                                                             monkeypatch):
    copy = tmp_path / "port_bench"
    shutil.copytree(HB.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((copy / "workloads" / "hypernerf-train-gaussian.json")
                    .read_text())
    wl["per_layer"].append("new_metric.train")
    (copy / "workloads" / "new-cell.json").write_text(json.dumps(wl))
    (copy / "traffic" / "new-mix.json").write_text(json.dumps({"x": 1}))
    (copy / "metrics" / "new_metric.train.py").write_text(
        "UNIT = 'ms'\n\ndef read(m):\n    return 1.5 if m else None\n")
    monkeypatch.setattr(HB, "BENCH_DIR", str(copy))
    assert "new-cell" in HB.names("workloads")
    assert "new-mix" in HB.names("traffic")
    assert "new_metric.train" in HB.names("metrics", ".py")
    assert HB.load_json("workloads", "new-cell")["per_layer"][-1] == \
        "new_metric.train"
    assert HB.load_module("metrics", "new_metric.train").read({"a": 1}) == 1.5
