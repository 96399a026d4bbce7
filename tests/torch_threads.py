"""One torch intra-op thread for a test module's small CPU ops.

The test workers share the machine's cores; a pool of one thread per core in
every worker oversubscribes them, and each small op then waits on its pool
(a test of a few hundred milliseconds alone took tens of seconds beside five
other workers). A module opts in with::

    from torch_threads import one_intra_op_thread  # noqa: F401

Values do not depend on it: every comparison in those modules is between
runs of the same process, against a tolerance, or with the subprocess given
``SUBPROCESS_ENV`` (the same one thread).
"""

import pytest
import torch

#: The environment of a CLI subprocess whose results a test holds bitwise
#: against the test process's own.
SUBPROCESS_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
