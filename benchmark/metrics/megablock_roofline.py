"""megablock_roofline: kernels B1 and B2 over the traced steps, the sum of
their least times (counts.megablock_step_bound_s at the padded V the
kernels run) over the sum of their device times (the row, x_hat and grads
kernels and both partial sums), as a share (%)."""

KERNELS = ("megablock_fwd_rows_kernel", "megablock_fwd_xhat_kernel",
           "xhat_reduce_kernel", "megablock_bwd_rows_kernel",
           "megablock_bwd_grads_kernel", "grad_reduce_kernel")


def read(record):
    tr, bound = record["trace"], record["trace_counts"].get(
        "megablock_bound_s")
    if tr is None or not bound:
        return None
    t = tr.kernel_seconds(*KERNELS)
    return 100.0 * bound / t if t > 0 else None
