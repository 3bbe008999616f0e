"""The port's per-chunk rel stage vs the JAX package's on the two fuzz-seed
regression reads (tolerance as in test_torch_rel.py): tie8339 read 94, an
exact f64 tie between two different expressions, and initkill21517 read
82 (-M model), the init cell's softmax-underflow kill."""
import pytest

from test_torch_rel import check_fixture


@pytest.mark.parametrize("fx", ["tie8339", "initkill21517"])
def test_rel_only_matches_jax_seed_reads(fx):
    assert check_fixture(fx) > 0
