"""program_ms_per_request: host milliseconds of the port's span
dnt.serve.program (the host launching the exported program) in a request, mean
over the window's dnt.serve records. The window's records are the W
dnt.serve records before the last 2n (W the window's requests, n a traced
stretch's: `dnbench.spans.window_records`); None with fewer, or without
the port's registry. A benchmark change should replace that arithmetic by
a reset() of the registry at the window's start."""

from dnbench import spans


def read(record):
    recs = spans.window_records(record, "dnt.serve")
    return None if recs is None else 1e3 * spans.mean(
        [r.child_s("dnt.serve.program") for r in recs])
