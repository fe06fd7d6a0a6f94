"""data_ms_per_step: the port's own span dnt.batch (the making of one
batch: the gather of its rows on the card), mean host milliseconds over the
window's batches. The window's records are the W dnt.batch records before
the last 2n (W the window's steps, n a traced stretch's:
`dnbench.spans.window_records`); None with fewer, or without the port's
registry. A benchmark change should replace that arithmetic by a reset()
of the registry at the window's start."""

from dnbench import spans


def read(record):
    recs = spans.window_records(record, "dnt.batch")
    return None if recs is None else 1e3 * spans.mean([r.seconds
                                                       for r in recs])
