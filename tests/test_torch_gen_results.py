"""The port's results tool (diffusionnet_tpu_torch/experiments/tools/
gen_results.py) on temporary directories: the sections that run here at a
small size (bench, eigen on the CPU), the output parsers on the examples'
and pytest's own lines, and the render, which puts the card beside every
number and says "no port benchmark yet" until the port writes one. The
JAX tool's docs/results/ and docs/RESULTS.md are not touched."""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from diffusionnet_tpu_torch.experiments.tools import gen_results as G
from tests.meshgen import flat_grid
from tests.torch_threads import one_torch_thread  # noqa: F401

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _jsonl(d, name, records):
    with open(os.path.join(d, name + ".jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def test_flat_grid_is_the_jax_tools_mesh():
    v, f = G.flat_grid(20, jitter=0.4)
    v2, f2 = flat_grid(n=20, jitter=0.4)
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)


def test_bench_reads_only_the_ports_files(tmp_path):
    root, out = tmp_path / "root", tmp_path / "out"
    root.mkdir()
    (root / "BENCH_r01.json").write_text(json.dumps({"metric": "tpu"}))
    (root / "MULTICHIP_r01.json").write_text(json.dumps({"metric": "tpu"}))
    G.section_bench(str(out), str(root))
    assert G._read_jsonl("bench", str(out)) == []
    (root / "bench_torch_seg.json").write_text(json.dumps(
        [{"metric": "step", "value": 1.5, "unit": "ms", "card": CARD}]))
    G.section_bench(str(out), str(root))
    recs = G._read_jsonl("bench", str(out))
    assert [(r["artifact"], r["metric"]) for r in recs] == [
        ("bench_torch_seg.json", "step")]


def test_eigen_section_on_the_cpu(tmp_path):
    G.section_eigen(n=40, k_eig=16, device="cpu", out_dir=str(tmp_path))
    (r,) = G._read_jsonl("eigensolver", str(tmp_path))
    assert r["device"] == "cpu" and r["card"]
    assert "1600 verts, k=16" in r["metric"]
    assert r["band_max_rel_err"] < 1e-6
    assert r["diffusion_output_max_rel_err"] < 1e-4
    assert r["hks_max_rel_err"] < 1e-4
    assert r["f32_band_max_rel_err"] < 1e-4


def test_eigen_section_defaults_to_the_card(tmp_path, monkeypatch):
    """Without a card the default device raises; it never falls back to
    the CPU and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        G.section_eigen(n=10, k_eig=4, out_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_a_failed_run_writes_no_record(tmp_path, monkeypatch):
    def failing(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, "boom\n", "")
    monkeypatch.setattr(G.subprocess, "run", failing)
    monkeypatch.setattr(G, "card_line", lambda: CARD)
    with pytest.raises(G.SectionFailed, match="synthetic_shrec exited 1"):
        G.section_synthetic(device="cpu", out_dir=str(tmp_path))
    with pytest.raises(G.SectionFailed, match="pytest exited 1"):
        G.section_parity(out_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_main_passes_the_device_and_exits_non_zero_on_a_failure(
        monkeypatch):
    seen = []

    def failing(device):
        raise G.SectionFailed("synthetic_shrec exited 1")
    monkeypatch.setattr(G, "section_synthetic", failing)
    monkeypatch.setattr(G, "section_eigen",
                        lambda device: seen.append(("eigen", device)))
    monkeypatch.setattr(G, "section_soak",
                        lambda device: seen.append(("soak", device)))
    with pytest.raises(SystemExit) as e:
        G.main(["--sections", "synthetic,eigen,soak", "--device", "cpu"])
    assert "synthetic (synthetic_shrec exited 1)" in str(e.value.code)
    assert seen == [("eigen", "cpu"), ("soak", "cpu")]
    seen.clear()
    G.main(["--sections", "eigen"])
    assert seen == [("eigen", "cuda")]


def test_parsers():
    out = ("epoch 3: train fmap L2 1.0e-01\n"
           "held-out pair: fmap L2 3.2500e-02, geodesic err 0.1\n"
           "    orig: exact-label acc  91.50%   mean angular err   3.21 deg\n"
           "   cloud: exact-label acc  88.25%   mean angular err   4.50 deg\n"
           "Overall test accuracy: 097.500%\n")
    got = G.parse_example(out, {
        "acc": G.SHREC_ACC["test_accuracy_pct"],
        "l2": r"held-out pair: fmap L2 ([\d.e+-]+)",
        "last": r"exact-label acc\s+([\d.]+)%",
        "deg": r"mean angular err\s+([\d.]+) deg",
        "absent": r"nothing (\d+)"})
    assert got == {"acc": 97.5, "l2": 0.0325, "last": 88.25, "deg": 4.5}
    assert G.parse_pytest_summary(
        "...s\n2 passed, 1 skipped in 3.2s\n") == {"passed": 2, "skipped": 1}
    assert G.parse_pytest_summary(
        "1 failed, 4 passed, 2 errors in 9s") == {
            "failed": 1, "passed": 4, "errors": 2}
    assert G.parse_pytest_summary("no tests ran") == {}


def test_render_puts_the_card_beside_every_number(tmp_path):
    d = str(tmp_path)
    _jsonl(d, "eigensolver", [{
        "metric": "device eigensolve @ 20164 verts, k=128", "device": "cuda",
        "card": CARD, "band_max_rel_err": 1e-9,
        "diffusion_output_max_rel_err": 2e-7, "hks_max_rel_err": 3e-7,
        "f32_band_max_rel_err": 1e-5, "f32_diffusion_output_max_rel_err": 2e-5,
        "device_s": 1.2, "sweeps_only_s": 0.9, "first_call_s": 1.5,
        "arpack_s": 20.0}])
    _jsonl(d, "synthetic", [{"script": "s", "args": "--n_epoch 40",
                             "returncode": 0, "wall_s": 30.0,
                             "test_accuracy_pct": 97.5, "card": CARD}])
    _jsonl(d, "pretrained_parity", [{
        "suite": "tests/test_torch_convert_checkpoint.py", "returncode": 0,
        "passed": 10, "skipped": 2, "card": "cpu",
        "note": "skipped: reference checkpoints absent"}])
    _jsonl(d, "soak", [{"script": "s", "args": "--n_epoch 200",
                        "returncode": 0, "wall_s": 600.0,
                        "test_accuracy_pct": 99.0, "card": CARD,
                        "config": "soak"}])
    path = str(tmp_path / "RESULTS_TORCH.md")
    text = G.render(d, path)
    assert open(path).read() == text
    assert "No port benchmark yet." in text
    assert "skipped: reference checkpoints absent" in text
    for line in text.splitlines():
        if line.startswith("- "):
            assert f"[{CARD}]" in line or "[cpu]" in line, line
    assert text.count(f"[{CARD}]") == 3


def test_unknown_section_is_refused():
    with pytest.raises(SystemExit, match="unknown section"):
        G.main(["--sections", "eigen,nope"])


def test_paths_stay_apart_from_the_jax_tools():
    assert G.OUT_DIR.endswith(os.path.join("docs", "results_torch"))
    assert G.RENDERED.endswith(os.path.join("docs", "RESULTS_TORCH.md"))
