"""The harness end to end at tiny sizes on the CPU: the reference agrees
with the port, the result line has the contract's keys, a cell and a
metric added as files are found, the harness refuses to run without a
card, and nothing it runs imports JAX or the JAX package."""

import ast
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from conftest import BENCH, ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101


def run_tiny(cell, seconds=0.3):
    import run as bench_run
    return bench_run.run_cell(cell, SEED, seconds, False, CPU,
                              time.perf_counter())


@pytest.mark.parametrize("workload", ["hseg_train", "siv_train"])
def test_reference_agrees_with_the_port_in_training(tiny, workload):
    line = run_tiny(tiny(workload))
    c = line["checks"]
    # the CPU runs the port's plain versions: the same products, other
    # orders of summation
    assert c["loss_rel"]["value"] < 1e-5
    assert c["grad_norm_gap"]["value"] < 1e-5
    # Adam moves A_im's diagonal (a gradient of exactly 0) by round-off
    assert c["change_norm_gap"]["value"] < 2e-2
    assert line["attempted"] > 0 and line["failed"] == 0


def test_reference_agrees_with_the_port_in_serving(tiny):
    line = run_tiny(tiny("hseg_serve"), seconds=1.0)
    assert line["checks"]["serve_max_gap"]["value"] < 1e-5
    assert line["correct"] is True


def test_result_line_has_the_contract_keys(tiny):
    line = run_tiny(tiny("hseg_serve"))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"request_p95_ms", "requests_per_s",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(line)


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path, tiny):
    from dnbench import spec
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "hseg_serve_small", "config": "human_seg_hks_c128",
        "traffic": "serve_small_closed", "chips": 1, "why": "added"})
    bench["per_layer"].append({
        "name": "kept_requests", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "serving",
        "moves": "requests_per_s", "workloads": ["hseg_serve_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads(
        (BENCH / "traffic" / "serve_large_closed.json").read_text())
    traffic.update(v_min=5000, v_max=20000, buckets=[8192, 32768])
    (root / "benchmark" / "traffic" / "serve_small_closed.json").write_text(
        json.dumps(traffic))
    (root / "benchmark" / "limits" / "hseg_serve_small.json").write_text(
        json.dumps({"limits": {"serve_max_gap": 1e-3}}))
    (root / "benchmark" / "metrics" / "kept_requests.py").write_text(
        "def read(record):\n    return record.get('sampled')\n")
    cell = spec.load_cell(root, "hseg_serve_small", root / "benchmark")
    assert cell.traffic["v_max"] == 20000
    assert cell.per_layer[-1] == "kept_requests"
    got = spec.read_metrics(["kept_requests"], {"sampled": 7}, cell.units,
                            root / "benchmark")
    assert got == {"kept_requests": {"value": 7.0, "unit": "requests"}}
    # a reader with nothing to read leaves its metric out
    assert spec.read_metrics(["kept_requests"], {}, cell.units,
                             root / "benchmark") == {}


def test_no_card_no_result(capsys, monkeypatch):
    import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_run, "pin_cores", lambda: None)
    rc = bench_run.main(["--workload", "hseg_train", "--seed", str(SEED),
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "diffusionnet_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "diffusionnet_tpu_torch" not in _imports(f), f
        assert _imports(f) <= {"__future__", "contextlib", "math", "torch"}, f


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import run as bench_run
    monkeypatch.setitem(sys.modules, "diffusionnet_tpu_torch_x", object())
    assert "diffusionnet_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in bench_run.forbidden_modules()
