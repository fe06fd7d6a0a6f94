"""mfu.serve: the model's forward products on the real vertices of every
request served in the window, over the window's wall seconds, as a share
of PEAK_FLOPS (%). Counted by the benchmark's frozen model_flops."""

from dnbench.counts import PEAK_FLOPS


def read(record):
    w = record["window"]
    if not w.get("requests") or not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / w["wall_s"] / PEAK_FLOPS
