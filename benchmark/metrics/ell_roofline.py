"""ell_roofline: the ELL gradient products' least time over a stretch's
steps (`dnbench.fmap_counts.ell_shape_bytes` of the steps' shapes: on
their real rows, the operators' indices and values, the signal and the
products, once each, forward and backward, at 3.35 TB/s) over the device
time of what was launched inside dnt.ell in those steps (see
ell_ms_per_step), as a share (%). None without that span."""


def read(record):
    tc = record["trace_counts"]
    t = (tc.get("span_device_s") or {}).get("dnt.ell")
    bound = tc.get("ell_bound_s")
    return 100.0 * bound / t if t and bound else None
