"""spectral_fused_roofline: kernel B4 over the traced requests, the sum of
its least times (counts.fused_bound_s at each request's bucket, one per
block) over the device time of `spectral_project`, `spectral_apply` and
`xhat_reduce` (its partial sum), as a share (%)."""

KERNELS = ("spectral_project_kernel", "spectral_apply_kernel",
           "xhat_reduce_kernel")


def read(record):
    tr, bound = record["trace"], record["trace_counts"].get("fused_bound_s")
    if tr is None or not bound:
        return None
    t = tr.kernel_seconds(*KERNELS)
    return 100.0 * bound / t if t > 0 else None
