"""requests_per_s: requests completed in the window over its wall time,
which runs to the last one's output on the host; host clock."""


def read(record):
    w = record["window"]
    return w["requests"] / w["wall_s"] if w.get("requests") else None
