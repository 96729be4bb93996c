"""The one-thread module fixture of the port's pipeline tests.

These tests run long loops of small torch ops, which gain nothing from
intra-op threads; under the suite's parallel workers the threads of every
worker contend for the cores (the K = 256 chain of test_torch_graph took
384 s instead of 14 s), so each such module runs on one. A test module
takes it with `from tests._torch_threads import one_torch_thread`."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
