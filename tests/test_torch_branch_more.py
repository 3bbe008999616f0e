"""The branch-coverage fixtures of test_torch_branch.py's MORE list: the
port's rel stage vs the JAX package's and the engine's bytes vs the
reference golden (see test_torch_branch.py)."""
import pytest

from test_torch_branch import MORE, NAMES, REST, check_branch


def test_split_names_exist():
    assert set(MORE) | set(REST) <= set(NAMES)
    assert not set(MORE) & set(REST)


@pytest.mark.parametrize("name", MORE)
def test_branch_fixture_rel_and_bytes_more(name):
    check_branch(name)
