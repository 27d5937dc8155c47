"""The check must fail what it exists to catch.

- The controls: the reference at the precision below the configuration's
  (an int4 tower, a float8 head), put in the program's place, fail at least
  one of the cell's numbers against the cell's own limits, here at a small
  size on the CPU.
- The faults (``vqabench.faults``): a run driven through the harness on the
  CPU at a small size (the look for a card skipped), with the timed path
  broken underneath, comes out not correct.
- On a card (marker ``cuda``): one run of the command as the check runs it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch
from vqabench_tiny import cpu_threads, tiny_cell

from vqabench import faults, harness, judge
from vqabench.reference import steps as ref_steps

CELLS = ("attention.train.b160", "baseline.train.b160", "attention.serve.b160",
         "baseline.serve.b160")
# the controls each cell's limits catch at the cell's own size (PERF.md)
CAUGHT = {name: ("int4_tower", "fp8_head") for name in CELLS}


def _limits(name: str) -> dict:
    return harness.load_json(harness.BENCH, "limits", f"{name}.json")


@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_the_check(name):
    cpu_threads()
    c = tiny_cell(name, limits=_limits(name))
    loop = harness.load_module("traffic", c.traffic["loop"]).Loop(c, 2 ** 31 + 41, "cpu")
    loop.setup()
    loop.window(0.2)
    loop.release()
    reference = loop.reference()
    for control in CAUGHT[name]:
        numbers = loop.numbers(loop.control_outputs(ref_steps.CONTROLS[control]), reference)
        assert not judge.verdict(numbers, c.limits), (control, numbers)


FAULTS = [(c, f) for c in CELLS[:2] for f in faults.TRAIN] + \
    [(c, f) for c in CELLS[2:] for f in faults.SERVE]


@pytest.mark.parametrize("name, fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_faults_fail_the_check(name, fault, monkeypatch):
    cpu_threads()
    c = tiny_cell(name, limits=_limits(name))
    fault(monkeypatch.setattr)
    result = harness.execute(c, 2 ** 31 + 43, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] is False, result["checks"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    """The command as the check runs it: a result line, correct, with every
    end-to-end metric of the cell."""
    out = subprocess.run([sys.executable, "-m", "vqabench.run", "--workload",
                          "baseline.serve.b160", "--seed", str(2 ** 31 + 47), "--seconds", "3",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"serve_qa_per_s", "serve_batch_p95_ms", "setup_s"}
