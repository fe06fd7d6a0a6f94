"""mfu.train: the model's products on the real vertices of every mesh
trained in the window (forward x 3), over the window's wall seconds, as a
share of PEAK_FLOPS (%). Counted by the benchmark's frozen model_flops."""

from dnbench.counts import PEAK_FLOPS


def read(record):
    w = record["window"]
    if "meshes" not in w or not w["model_flops"]:
        return None
    return 100.0 * w["model_flops"] / w["wall_s"] / PEAK_FLOPS
