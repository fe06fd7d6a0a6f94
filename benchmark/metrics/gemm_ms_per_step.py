"""gemm_ms_per_step: device milliseconds of library GEMM kernels (cuBLAS,
cuBLASLt, CUTLASS) over the traced steps, per step."""

import re

GEMM = re.compile(r"gemm|gemv|cutlass|xmma|splitKreduce|cublas", re.I)


def read(record):
    tr, n = record["trace"], record["trace_counts"].get("steps")
    if tr is None or not n:
        return None
    return 1e3 * sum(s for k, s in tr.kernels.items() if GEMM.search(k)) / n
