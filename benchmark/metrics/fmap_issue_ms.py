"""fmap_issue_ms: host milliseconds a train step spends in the port's span
dnt.fmap (the functional-map head's forward: projections, systems,
solve), inside dnt.step, mean over the window's steps. The window's
records are the W dnt.step records before the last 2n (W the window's
steps, n a traced stretch's: `dnbench.spans.window_records`); None with
fewer, without the port's registry, or when no step recorded the span."""

from dnbench import spans


def read(record):
    recs = spans.window_records(record, "dnt.step")
    if recs is None or not any("dnt.fmap" in r.children for r in recs):
        return None
    return 1e3 * spans.mean([r.child_s("dnt.fmap") for r in recs])
