"""request_p95_ms: the 95th percentile (linear between order statistics)
of the milliseconds each request of the window took from its call to its
output on the host, over every request of the window; host clock."""

import numpy as np


def read(record):
    s = record["window"].get("latencies_ms")
    return float(np.percentile(s, 95)) if s else None
