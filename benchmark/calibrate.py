#!/usr/bin/env python3
"""Readings for a cell's limits: the numbers that decide `correct`, from
the program on many seeds, and from the control and the planted faults
with the reference put in the program's place, at the cell's own sizes.

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> \
        --seeds 11,12,13 [--seconds 10] [--requests 1200]

modes: program (a run of the cell, untraced, --seconds long, per seed;
with --witness, for training, the program and the float32 reference also
against the reference in float64);
control (the reference in TF32 against the reference in float32); for
training cells half (each batch's first half only, the mean over it) and
altered (64 outputs of each batch's first surface rolled by one class);
for serving cells altered (one face's first two log-probabilities
swapped). A state left unchanged reads 1 by the measure and needs no run.
One JSON line per seed on standard output. Needs a card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def reference(cell, data, seed, device, prec):
    """The reference's first steps of a training run with this seed."""
    from dnbench import inputs, spec
    loop = spec.loop_module(cell)
    batches, seeds = loop.first_batches(cell.config, data,
                                        inputs.sub_seed(seed, "fit"),
                                        cell.traffic["checked_steps"])
    return loop.reference_steps(cell.config, data, batches, seeds, prec,
                                device)


def program(cell, seed, seconds, device, t0, witness):
    from dnbench import compare, spec
    loop = spec.loop_module(cell)
    rec = loop.run(cell, seed, seconds, False, device, t0)
    out = dict(rec["readings"], attempted=rec["attempted"],
               failed=rec["failed"], setup_s=rec["setup_s"])
    if witness:
        data = loop.Data(cell.config, seed, device)
        w64 = reference(cell, data, seed, device, "f64")
        out["program_vs_f64"] = compare.train_readings(rec["program"], w64)
        out["f32_vs_f64"] = compare.train_readings(
            reference(cell, data, seed, device, "f32"), w64)
    return out


def training(cell, seed, device):
    from dnbench import compare, spec
    data = spec.loop_module(cell).Data(cell.config, seed, device)
    return compare.train_readings(
        reference(cell, data, seed, device, "tf32"),
        reference(cell, data, seed, device, "f32"))


def serving(cell, seed, device, n_requests):
    from dnbench import inputs, spec
    loop = spec.loop_module(cell)
    m = cell.config["model"]
    flat = inputs.weights(m, seed, device, trained=True)
    pool = loop.Pool(cell.config, cell.traffic, seed, device)
    reqs = loop.Requests(cell.traffic, pool, seed, m["c_in"])
    kept = {}
    for r in (r for r in range(n_requests) if reqs.keep(r)):
        kept[r] = loop.reference_out(cell.config, pool, reqs, flat, r,
                                     "tf32", device).cpu().numpy()
    return {"serve_max_gap": loop.reference_gap(cell.config, pool, reqs,
                                                flat, kept, device),
            "sampled": len(kept)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "control", "unchanged", "half",
                            "altered"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--requests", type=int, default=1200)
    p.add_argument("--witness", action="store_true",
                   help="program mode, training: also the program and the "
                        "float32 reference against the reference in "
                        "float64")
    args = p.parse_args(argv)
    bench_run.set_cache_dirs(bench_run.ROOT)
    for d in (str(bench_run.ROOT), str(bench_run.BENCH)):
        if d not in sys.path:
            sys.path.insert(0, d)
    import torch

    from dnbench import faults, spec
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(bench_run.ROOT, args.workload)
    serve = cell.traffic["loop"] == "serve_closed"
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.mode == "program":
            out = program(cell, seed, args.seconds, device, t,
                          args.witness and not serve)
        elif args.mode == "control":
            out = (serving(cell, seed, device, args.requests) if serve
                   else training(cell, seed, device))
        else:
            patches = faults.Patches()
            (faults.SERVING if serve else faults.TRAINING)[args.mode](
                patches.setattr)
            try:
                out = program(cell, seed, args.seconds, device, t, False)
            finally:
                patches.undo()
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "readings": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
