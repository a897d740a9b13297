"""What the benchmark loads: no jax, jaxlib, flax or the JAX package
(top-level names compared whole, so trase_tpu_torch passes), and a
reference that imports nothing of the port."""
import ast
import json
import os
import subprocess
import sys

from port_bench import harness as HB

PROBE = r"""
import importlib.util, json, os, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)
from port_bench import harness as HB
for name in HB.names("modes", ".py"):
    HB.load_module("modes", name)
for name in HB.names("metrics", ".py"):
    HB.load_module("metrics", name)
import port_bench.reference.plain, port_bench.reference.train_step
import port_bench.reference.feature_step, port_bench.controls
tops = sorted({{k.split(".")[0] for k in sys.modules}})
print(json.dumps(tops))
"""


def loaded_tops(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_of_the_jax_side_is_loaded():
    tops = loaded_tops(PROBE.format(root=HB.ROOT, run=os.path.join(
        HB.BENCH_DIR, "run.py")))
    assert not tops & set(HB.FORBIDDEN), tops & set(HB.FORBIDDEN)


def test_the_check_compares_top_level_names_whole():
    assert HB.forbidden_modules(["trase_tpu_torch", "trase_tpu_torch.ops",
                                 "jaxtyping", "numpy"]) == []
    assert HB.forbidden_modules(["trase_tpu.ops", "jax.numpy", "flax",
                                 "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                    "trase_tpu"]


def test_the_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(HB.BENCH_DIR, "reference")
    for f in os.listdir(ref_dir):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("trase_tpu_torch", "trase_tpu",
                                               "jax", "flax"), (f, n)
    code = (f"import sys, json; sys.path.insert(0, {HB.ROOT!r})\n"
            "import port_bench.reference.train_step, "
            "port_bench.reference.feature_step\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    assert "trase_tpu_torch" not in loaded_tops(code)
