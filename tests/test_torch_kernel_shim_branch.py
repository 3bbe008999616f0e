"""The DP kernel's per-row body (g++ shim) against the plain torch DP on
the branch fixtures that reach its rare paths: the all-dead final cell
(psum0, psum0multi) and the rescue pass's active mask (search9).
Tolerance as in test_torch_kernel_shim.py."""
import pytest

from test_torch_kernel_shim import check_shim_on_packs


@pytest.mark.parametrize("fx", ["psum0", "psum0multi", "search9"])
def test_shim_matches_ref_on_branch_packs(fx):
    rescue = check_shim_on_packs(f"branch/{fx}")
    if fx == "search9":
        assert bool(rescue.any()), "search9 no longer exercises the rescue pass"
