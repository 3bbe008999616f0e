"""The all-device path's batched guard (``TorchEngine._exact_alldev``:
one ``exact_rel_batch`` and one ``finish_batch`` per chunk) on the 83x
dataset of test_torch_guard_batch.py, where the device flags most reads:
at -T 1 and -T 4 it writes the JAX package's ``TpuEngine`` bytes (main
path, CPU), and on one chunk of the first 24 reads its bytes and
guard_flagged equal the JAX package's all-device fallback (its Python
wall stage, ``classify_batch_dev`` and the Python oracle for each
flagged read, seconds per read, hence the chunk).  Tolerance: byte
equality.
"""
import pytest
import torch

from test_torch_guard_batch import _port, jax_main, soak83  # noqa: F401

torch.set_num_threads(1)

JAX_ALLDEV_READS = 24


@pytest.mark.parametrize("threads", [1, 4])
def test_soak83_alldev_equals_jax(soak83, jax_main, threads):  # noqa: F811
    out, flagged = _port(soak83, True, threads)
    want, _ = jax_main
    assert out == want
    assert flagged >= 0.2 * len(out)            # the guard really fires


def test_soak83_alldev_flags_equal_jax_alldev(soak83):  # noqa: F811
    """The all-device path against the JAX package's all-device fallback
    (its Python wall stage, ``classify_batch_dev`` and the Python oracle
    for each flagged read) on one chunk of the first reads: the same
    bytes and the same guard_flagged."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.tpu.engine import TpuEngine, _PyWall

    root, seqs, profs = soak83
    n = JAX_ALLDEV_READS
    jgm = build_global_model(load_histogram(root))
    jeng = TpuEngine(jgm, batch_size=n)
    jeng.wall = _PyWall(jgm)                    # force the fallback
    want = jeng.classify_chunk(seqs[:n], profs[:n])
    out, flagged = _port(soak83, True, 4, n=n, B=n)
    assert out == want
    assert flagged == jeng.guard_flagged >= 0.2 * n
