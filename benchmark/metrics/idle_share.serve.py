"""idle_share.serve: 100 x (1 - the union of device activity intervals
over the traced window's wall time), over traced requests."""


def read(record):
    tr = record["trace"]
    if tr is None or "requests" not in record["trace_counts"]:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
