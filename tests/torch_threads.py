"""One intra-op thread for each of the port's tests.

The tests run in several processes at once on one host. At torch's default
of one intra-op thread per core, the processes' threads wait on each
other's cores at every op's barrier, and the many small ops of these tests
run tens or hundreds of times slower than in one process alone. Every
tests/test_torch_*.py imports `one_torch_thread`, an autouse fixture of
module scope (so it is set before the module's other fixtures run, and put
back after the module). A process that a test starts sets it in its own
process: a subprocess through `one_thread_env()` (torch reads
OMP_NUM_THREADS at start), a rank spawned by `parallel.launch` through its
`threads=1` default.
"""

import os

import pytest
import torch


def one_thread_env(**extra) -> dict:
    """The environment of a subprocess that runs torch on one thread."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
