"""On the card: each cell's command runs for a few seconds, prints one
result line and comes out correct (run: python -m pytest skybench/tests -m card)."""

import json
import subprocess
import sys

import pytest

from skybench import run
from skybench.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in run.load_benchmark(ROOT)["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "-m", "skybench.run", "--workload", cell,
                        "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
