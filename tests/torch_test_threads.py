"""One intra-op thread for torch in the port's tests (not a pytest file).

Every ``tests/test_torch_*.py`` imports this module first.  The suite runs
several pytest-xdist workers at once on a few cores; torch's default of one
intra-op thread a core makes them fight for the cores, and a CPU-heavy case
then runs many times slower than alone.  One thread a worker keeps each
case near its single-core time.  xdist's collection imports every test
module in every worker, so the cap holds in all of them.
"""
import contextlib

import torch

#: torch's own choice for this process, before the cap
DEFAULT = torch.get_num_threads()
THREADS = 1

torch.set_num_threads(THREADS)


@contextlib.contextmanager
def default_threads():
    """torch's own thread count within the block, the cap again after: for
    a comparison whose reference was set at that count (CPU kernels pick
    their algorithm, and so their rounding, by the thread count)."""
    torch.set_num_threads(DEFAULT)
    try:
        yield
    finally:
        torch.set_num_threads(THREADS)
