"""A run of each cell on the card, at a short window: correct, with the
result line's keys. Skips without a CUDA card (decided in the fixture).

    python -m pytest portbench/tests/test_portbench_card.py -m gpu -q
"""

import json
import subprocess
import sys

import pytest

from portbench.harness import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flat_shard_k10", "ivfpq_vectors_np128"])
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
                          "2147483655", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
