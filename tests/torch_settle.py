"""An autouse fixture for the port's test modules whose tests run audit
passes.  A pass settles the state it built out of the cyclic collector's
walk (``gc.freeze()``, ``gatekeeper_tpu_torch/audit/manager.py``); after
each test the freeze is lifted, so one test's objects do not stay frozen
in its worker for the tests after it.  A module takes it by importing it:

    from tests.torch_settle import unfreeze_after_each_test  # noqa: E402,F401
"""

import pytest

from gatekeeper_tpu_torch.audit.manager import unfreeze_settled


@pytest.fixture(autouse=True)
def unfreeze_after_each_test():
    yield
    unfreeze_settled()
