"""The numbers that decide `correct`, and their limits.

Training (the first three steps of the timed path against the reference
from the same inputs and draws):
  loss_rel        the first step's |loss - ref| / |ref| (the later steps'
                  losses move by Adam's +-lr updates of elements whose
                  gradient is rounding noise: loss_rel_3 is the largest
                  of the three, printed but not compared);
  grad_norm_gap   the worst leaf's | |g| - |g_ref| | / max(|g_ref|, the
                  median leaf's |g_ref|), g the first step's gradient as
                  the optimizer got it (its first moment / 0.1);
  change_norm_gap the same of each leaf's change over the three updates,
                  leaving out leaves whose reference gradient is under a
                  thousandth of the median leaf's (Adam moves those by
                  round-off alone).
Serving: serve_max_gap, the largest |log p - log p_ref| over every face
and class of the sampled requests.
Each must be at most its limit (benchmark/limits/<cell>.json).
"""

from __future__ import annotations

import math
import statistics


def leaf_gap(prog: dict, ref: dict, keys=None) -> float:
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def train_readings(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}."""
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(prog["losses"], ref["losses"])]
    med = statistics.median(ref["grad_norms"].values())
    moved = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * med]
    return {"loss_rel": rel[0], "loss_rel_3": max(rel),
            "grad_norm_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_norm_gap": leaf_gap(prog["change_norms"],
                                        ref["change_norms"], moved)}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every limit has
    a finite reading at or under it."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
