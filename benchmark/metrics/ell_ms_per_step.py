"""ell_ms_per_step: device milliseconds a step of the kernels, copies and
sets launched inside the port's span dnt.ell (every `ell_matvec`, forward
and backward), each charged through its launch's correlation id to the
innermost dnt.* annotation on the launching thread
(`dnbench.by_span`), over the traced stretch that records the host's
ops. None without that span (a port that does not record it)."""


def read(record):
    tc = record["trace_counts"]
    s, n = (tc.get("span_device_s") or {}).get("dnt.ell"), tc.get("steps")
    return 1e3 * s / n if s and n else None
