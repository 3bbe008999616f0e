"""The branch-coverage fixtures of test_torch_branch.py's REST list: the
port's rel stage vs the JAX package's and the engine's bytes vs the
reference golden (see test_torch_branch.py)."""
import pytest

from test_torch_branch import REST, check_branch


@pytest.mark.parametrize("name", REST)
def test_branch_fixture_rel_and_bytes_rest(name):
    check_branch(name)
