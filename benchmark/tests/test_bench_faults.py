"""A run with the timed path broken underneath comes out not correct: the
harness past its look for a card, at tiny sizes on the CPU, under the
cells' own limits, once for each fault the cell can have."""

import time

import pytest
import torch

from dnbench import faults

CPU = torch.device("cpu")
SEED = 2 ** 31 + 211


def run_tiny(cell, seconds=0.3):
    import run as bench_run
    return bench_run.run_cell(cell, SEED, seconds, False, CPU,
                              time.perf_counter())


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
@pytest.mark.parametrize("workload", ["hseg_train", "siv_train"])
def test_training_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    faults.TRAINING[fault](monkeypatch.setattr)
    assert run_tiny(tiny(workload))["correct"] is False


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
def test_serving_fault_is_not_correct(tiny, monkeypatch, fault):
    faults.SERVING[fault](monkeypatch.setattr)
    assert run_tiny(tiny("hseg_serve"), seconds=1.0)["correct"] is False
