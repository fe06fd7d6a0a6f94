"""What a cell is, read from data: `BENCHMARK.json` at the checkout's root
names the cell's configuration (a file under benchmark/configs/), its
traffic mix (benchmark/traffic/<traffic>.json, whose "loop" names the
driver benchmark/loops/<loop>.py) and its metrics (a reader
benchmark/metrics/<metric>.py each). The limits that decide `correct` are
benchmark/limits/<cell>.json. A later change adds a configuration, a mix,
a loop, a metric or a cell by adding files and entries; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)
    units: dict = field(default_factory=dict)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` of <root>/BENCHMARK.json, with its files read.
    Raises KeyError for a cell that is not there."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=conf["name"],
        config=_json(root / conf["file"]), traffic_name=w["traffic"],
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m["name"] for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m["name"] for m in bench["per_layer"]
                   if _applies(m, workload)],
        limits=_json(bench_dir / "limits" / f"{workload}.json")["limits"],
        units={m["name"]: m["unit"] for m in metrics})


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(cell: Cell, bench_dir: Path = BENCH_DIR):
    """The driver of the cell's traffic: benchmark/loops/<loop>.py, with
    run(cell, seed, seconds, trace, device, t0) -> a record for the
    metric readers."""
    loop = cell.traffic["loop"]
    return _module(bench_dir / "loops" / f"{loop}.py", f"bench_loop_{loop}")


def read_metrics(names: list, record: dict, units: dict,
                 bench_dir: Path = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader
    (benchmark/metrics/<name>.py, read(record) -> float or None) finds
    something to read; the others are left out."""
    out = {}
    for name in names:
        reader = _module(bench_dir / "metrics" / f"{name}.py",
                         "bench_metric_" + name.replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out
