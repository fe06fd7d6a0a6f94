"""batch_ms_per_step: host milliseconds inside the benchmark's span around
each next() of the batch iterator, over the window's steps."""


def read(record):
    w = record["window"]
    if not w.get("steps"):
        return None
    return 1e3 * w["batch_s"] / w["steps"]
