#!/usr/bin/env python3
"""One run of one benchmark cell of the port (diffusionnet_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up makes every input and weight from --seed, warms up the cell's
own shapes and drives the timed path's first steps for the check; the
window then measures for --seconds; after it the reference checks what
the timed path produced. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device (with --trace 1
also busy_s and window_s of a traced stretch run after the window),
breakdown (--trace 1), and last `checks`, each number compared beside its
limit (also the last lines of standard error).

Exits 2 without a result when no card (or too few) is visible, and 3 when
a module of JAX or of the JAX package is loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffusionnet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: diffusionnet_tpu_torch is not
    diffusionnet_tpu)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the port's own kernel library builds into build/torch_kernels/)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def pin_cores() -> None:
    """Keeps this process, and every thread it starts from now on, on the
    last two cores it may use. The cells' pace is the host's issue of work
    to the card, which ran faster, and varied less between processes, held
    on two cores than free to move over all of them (PERF.md, section 6)."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """The result line of one run of `cell` on `device`."""
    import torch

    from dnbench import compare, spec

    record = spec.loop_module(cell).run(cell, seed, seconds, trace, device,
                                        t0)
    names = cell.per_layer if trace else cell.end_to_end
    correct, checks = compare.judge(record["readings"], cell.limits)
    line = {"correct": bool(correct and record["failed"] == 0),
            "attempted": int(record["attempted"]),
            "failed": int(record["failed"]),
            "metrics": spec.read_metrics(names, record, cell.units),
            "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                       "count": cell.chips,
                       "memory_peak_bytes": int(record["memory_peak_bytes"])}}
    if trace and record["trace"] is not None:
        line["device"]["busy_s"] = record["trace"].busy_s
        line["device"]["window_s"] = record["trace"].window_s
        line["breakdown"] = record["trace"].breakdown()
    line["checks"] = checks
    print("set-up stages (s from start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in record["setup_stages"].items()),
        file=sys.stderr)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_cores()
    set_cache_dirs(ROOT)
    for d in (str(ROOT), str(BENCH)):
        if d not in sys.path:
            sys.path.insert(0, d)
    from dnbench import spec
    cell = spec.load_cell(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T0)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
