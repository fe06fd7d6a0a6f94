"""On the card (marker `cuda`; skipped elsewhere), at sizes a test run
holds: a sound run of each cell is correct, and the control (the
reference in TF32 put in the program's place) is not, under the cells'
own limits.

    python -m pytest benchmark/tests/test_bench_card.py -q -m cuda
"""

import copy
import time

import pytest


def reduced(cell):
    """The cell with fewer, smaller surfaces at its published widths."""
    c = copy.deepcopy(cell)
    d = c.config["dataset"]
    if c.config["model"]["outputs_at"] == "faces":
        c.config["fit"]["buckets"] = [8192]
        d.update(n_train=12, v_min=4000, v_max=8000, distinct_bundles=3)
    else:
        d.update(n_train=6, distinct_bundles=2)
    c.traffic.update(pool=2, v_min=20000, v_max=60000, buckets=[65536])
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hseg_train", "siv_train",
                                      "hseg_serve"])
def test_sound_run_is_correct_on_the_card(cuda, workload):
    import run as bench_run
    from dnbench import spec
    cell = reduced(spec.load_cell(bench_run.ROOT, workload))
    line = bench_run.run_cell(cell, 2 ** 31 + 7, 2.0, True, cuda,
                              time.perf_counter())
    assert line["correct"] is True, line["checks"]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hseg_train", "siv_train",
                                      "hseg_serve"])
def test_control_is_not_correct(cuda, workload):
    import calibrate
    import run as bench_run
    from dnbench import compare, spec
    cell = reduced(spec.load_cell(bench_run.ROOT, workload))
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        if cell.traffic["loop"] == "serve_closed":
            readings = calibrate.serving(cell, seed, cuda, 400)
        else:
            readings = calibrate.training(cell, seed, cuda)
        correct, checks = compare.judge(readings, cell.limits)
        assert correct is False, checks
