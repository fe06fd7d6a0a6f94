"""step_issue_ms: host milliseconds a train step spends issuing work, the
port's span dnt.step less its dnt.wait.* spans, mean over the window's
steps. The window's records are the W dnt.step records before the last 2n
(W the window's steps, n a traced stretch's:
`dnbench.spans.window_records`); None with fewer, or without the port's
registry. A benchmark change should replace that arithmetic by a reset()
of the registry at the window's start."""

from dnbench import spans


def read(record):
    recs = spans.window_records(record, "dnt.step")
    return None if recs is None else 1e3 * spans.mean(
        [r.seconds - r.wait_s() for r in recs])
