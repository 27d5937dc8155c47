"""No JAX in a run, nothing of the port in the reference, and the run's
refusal without a card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from vqabench import guard, harness

REFERENCE = os.path.join(harness.BENCH, "reference")


@pytest.mark.parametrize("names, found", [
    ({"vqa_tpu_torch", "vqa_tpu_torch.serve", "numpy", "jaxtyping"}, []),
    ({"vqa_tpu", "torch"}, ["vqa_tpu"]),
    ({"vqa_tpu.models.vgg"}, ["vqa_tpu"]),
    ({"jax._src.core", "jaxlib.xla_client", "flax.linen"}, ["flax", "jax", "jaxlib"]),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_loaded(names) == found


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_cells_set_up_loads_no_jax():
    """A fresh process runs one cell's set-up, window and check at a small
    size on the CPU; the guard then finds nothing."""
    tiny = os.path.join(os.path.dirname(os.path.abspath(__file__)))
    got = _run(f"""
import json, sys, time
sys.path.insert(0, {tiny!r})
from vqabench_tiny import tiny_cell, cpu_threads
from vqabench import guard, harness
cpu_threads()
res = harness.execute(tiny_cell("attention.serve.b160", limits={{}}), 5, 0.2, False, "cpu",
                      time.perf_counter())
print(json.dumps({{"found": guard.forbidden_loaded(), "port": "vqa_tpu_torch" in sys.modules,
                  "attempted": res["attempted"]}}))
""")
    assert got["found"] == [] and got["port"] and got["attempted"] > 0


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    """Neither the reference's source nor importing it brings in the port,
    the JAX package or JAX."""
    files = [os.path.join(REFERENCE, f) for f in os.listdir(REFERENCE) if f.endswith(".py")]
    assert len(files) >= 6
    for f in files:
        bad = _imports(f) & {"vqa_tpu_torch", "vqa_tpu", "jax", "jaxlib", "flax"}
        assert not bad, (f, bad)
    modules = [f"vqabench.reference.{os.path.basename(f)[:-3]}" for f in files]
    got = _run(f"""
import importlib, json, sys
for m in {modules!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}}
                        & {{"vqa_tpu_torch", "vqa_tpu", "jax", "jaxlib", "flax"}})))
""")
    assert got == []


def test_run_refuses_without_a_card():
    """Without a CUDA device a run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    out = subprocess.run([sys.executable, "-m", "vqabench.run", "--workload",
                          "attention.train.b160", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA device" in out.stderr
