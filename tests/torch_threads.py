"""One rule for the threads of the port's CPU tests.

The suite runs six workers at once on an eight-core machine. A worker whose
torch takes one intra-op thread per core competes with the other five, and
forwards that take a second alone then take minutes (a YOLOv9t forward went
from ~1 s to 66-191 s). So every ``tests/test_torch_*.py`` imports the
autouse fixture below, which tests/test_torch_package.py checks:

    from torch_threads import torch_threads  # noqa: F401

It holds torch at TORCH_THREADS for the whole module, its module-scoped
fixtures included, and sets OMP_NUM_THREADS for the processes the module's
tests start (CLI verbs, servers, gloo ranks); both are restored after the
module.
"""

import os

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(TORCH_THREADS)
    os.environ["OMP_NUM_THREADS"] = str(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp
