"""The benchmark's tests: its harness at tiny sizes on the CPU (the port's
plain versions run there), and, marked `cuda`, what needs the card.
Run from the repository root:

    python -m pytest benchmark/tests -q              # CPU; card tests skip
    python -m pytest benchmark/tests -q -m cuda      # on a machine with a card
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for _d in (str(ROOT), str(BENCH)):
    if _d not in sys.path:
        sys.path.insert(0, _d)


def shrink(cell):
    """The cell at a size the CPU runs in seconds: narrow models, few small
    surfaces, one small bucket (the megakernel tiles and B4's 1024-row
    tile still divide it)."""
    c = copy.deepcopy(cell)
    m = c.config["model"]
    m.update(c_width=8, mlp_hidden_dims=[8, 8], k_eig=16, n_block=2)
    if m["outputs_at"] == "vertices":
        m["n_class"] = 50
        c.config["dataset"].update(n_train=5, v_min=50, v_max=50,
                                   distinct_bundles=2)
    else:
        c.config["fit"]["buckets"] = [256]
        c.config["dataset"].update(n_train=9, v_min=100, v_max=200,
                                   distinct_bundles=3)
    c.traffic.update(pool=3, v_min=300, v_max=900, buckets=[1024],
                     max_requests=1000, signal_slack=4096, sample_stride=4)
    return c


@pytest.fixture
def tiny():
    from dnbench import spec

    def make(workload):
        return shrink(spec.load_cell(ROOT, workload))
    return make


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
