"""One torch thread for the port's CPU tests.

A parallel test run (pytest-xdist) puts several workers on the cores. The
port's tests run thousands of small torch ops (doll-house decodes, CLIs,
towers), and beside the other workers each op's parallel region over all
cores waits on descheduled threads: the infer CLI test took 1.98 s alone,
140 s beside five busy processes with torch's default threads, and 2.07 s
there with one thread. A test module takes the fixture by importing it:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
