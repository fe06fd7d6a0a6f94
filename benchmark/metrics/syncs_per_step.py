"""syncs_per_step: the times a train step's host blocks on the card, the
port's `syncs` counter (one a dnt.wait.* span) of dnt.step, mean over the
window's steps. The window's records are the W dnt.step records before the
last 2n (W the window's steps, n a traced stretch's:
`dnbench.spans.window_records`); None with fewer, or without the port's
registry. A benchmark change should replace that arithmetic by a reset()
of the registry at the window's start."""

from dnbench import spans


def read(record):
    recs = spans.window_records(record, "dnt.step")
    return None if recs is None else spans.mean(
        [r.counter("syncs")[0] for r in recs])
