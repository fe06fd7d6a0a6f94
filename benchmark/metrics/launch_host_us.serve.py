"""launch_host_us.serve: host microseconds a launch of the port's own
kernels takes in a request, from the wrapper's entry to the return of its
launch (checks, allocations, the launch): the port's `launch.*` counters'
seconds over their counts in the window's dnt.serve records. The window's
records are the W dnt.serve records before the last 2n (W the window's
requests, n a traced stretch's: `dnbench.spans.window_records`); None with
fewer, without the port's registry, or without launches. A benchmark
change should replace that arithmetic by a reset() of the registry at the
window's start."""

from dnbench import spans


def read(record):
    return spans.launch_host_us(spans.window_records(record, "dnt.serve"))
