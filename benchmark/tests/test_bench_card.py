"""On a CUDA card: one short run of each cell through the command, correct,
with the result line's device keys.  Skipped without a card (decided here,
inside the test)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import WORKLOADS


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", "2147483651", "--seconds", "2", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "funnel_ms" in r["metrics"] and r["breakdown"]["device_ops"]
