"""The port's test files' thread budget.

The suite runs six pytest workers on the machine's cores. Each torch
process would start as many intra-op threads as there are cores, and
numpy's BLAS as many again, so the workers' threads outnumber the cores
many times and spin against each other: a numpy test that takes 12 s
alone took 278 s in the suite. A port test file imports `few_threads` (a
module-scoped autouse fixture): while the module runs, torch uses two
intra-op threads (the ranks that `parallel.dryrun.spawn` starts take the
parent's count) and numpy's BLAS one. The JAX package's thread pool is
left as it is.
"""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(1, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(n)
