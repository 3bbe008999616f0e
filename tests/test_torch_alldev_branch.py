"""The branch-coverage fixtures of test_torch_alldev_engine.py's BRANCH_B
list through the all-device engine, against the reference goldens."""
import pytest

from test_torch_alldev_engine import BRANCH_B, check_branch


@pytest.mark.parametrize("name", BRANCH_B)
def test_alldev_engine_bytes_branch_b(name):
    check_branch(name)
