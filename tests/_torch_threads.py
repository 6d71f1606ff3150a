"""One intra-op thread for torch in the port's CPU tests.

Tier-1 runs the tests in six pytest-xdist workers on a host of a few cores.
torch's default pool holds one thread per core in every worker, so six of
them oversubscribe the host, and the narrow models' many small ops then
spend their time waiting on each other's threads: a narrow GCViT training
run that takes 2.2 s alone took 650 s with six copies side by side, and
2.3-2.9 s each with one thread per process. A test module that runs torch
models takes the fixture::

    from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

which holds torch to one thread for the module's tests and restores the
count after them. It changes no check; a parallel sum may round in
another order.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
