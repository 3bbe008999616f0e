"""The port's log-Skellam lookup and table builder vs the JAX package's.

The same (k, lam) pairs, made from a seed with numpy, go through
``skellam_dev.skellam_args``/``skellam_value`` (JAX, CPU) and the port's
``skellam.skellam_args``/``skellam_value`` (torch, CPU) over the same
packed table; the results must be bit-equal.  They cover both table
regions, x == 0, |k| > 384 (and k beyond int32), and the overflow and
underflow cutoffs.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _pairs():
    rng = np.random.default_rng(20)
    n = 4000
    k = rng.integers(-500, 501, n)
    lam = np.concatenate([
        rng.uniform(0.0, 32.0, n // 4),          # region A (x <= 64)
        rng.uniform(32.0, 8192.0, n // 4),       # region B
        rng.uniform(300.0, 400.0, n // 4),       # around the overflow cut
        rng.uniform(0.0, 2.0, n // 4)])          # large k: underflow cut
    edge_k = np.array([0, 0, 1, 384, 385, -385, 384, 2 ** 31 + 5,
                       -(2 ** 33), 7, 300, 250, 0, 5])
    edge_l = np.array([0.0, 32.0, 0.0, 0.5, 3.0, 3.0, 9000.0, 2.0, 2.0,
                       354.8913563, 0.5, 0.05, 1e-300, 32.000000000000004])
    return np.concatenate([k, edge_k]), np.concatenate([lam, edge_l])


def test_skellam_lookup_bit_equal_to_jax():
    from classpro_tpu.tpu import skellam_dev as J

    from classpro_tpu_torch import skellam as S

    tab, _lf = S.build_packed_skellam()
    k, lam = _pairs()

    # JAX: args, gather, value
    jk = jnp.asarray(k, jnp.int64)
    jl = jnp.asarray(lam, jnp.float64)
    n, idx, f, in_a, x, ka = J.skellam_args(jk, jl)
    jtab = jnp.asarray(tab)
    ps = J.PackedSkellam(tab=jtab, lf_n=jnp.asarray(_lf))
    want = np.asarray(J.skellam_value(jtab[n, idx], ps, n, f, in_a, x, ka,
                                      jl))

    # the port, torch on the CPU
    tk = torch.from_numpy(k)
    tl = torch.from_numpy(lam)
    got = S.logp_skellam(tk, tl, torch.from_numpy(tab)).numpy()

    # the edges really are reached
    assert np.isposinf(want).any() and np.isneginf(want).any()
    assert (2 * lam > S.XA_MAX).any() and (2 * lam <= S.XA_MAX).any()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))

    # intermediate arguments too (the kernel's rd::skellam repeats them)
    tn, tidx, tf, tin_a, tx, tka = S.skellam_args(tk, tl)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tf.numpy().view(np.int64),
                                  np.asarray(f).view(np.int64))
    np.testing.assert_array_equal(tin_a.numpy(), np.asarray(in_a))


@pytest.mark.parametrize("nmax", [16, 40])
def test_packed_table_builder_equals_jax(nmax, tmp_path, monkeypatch):
    """The port's copy of the table builder gives the JAX builder's packed
    table bit for bit (at reduced orders: the builder's arithmetic is per
    order, so this covers the code without the ~40 s full build twice)."""
    monkeypatch.setenv("CLASSPRO_CACHE", str(tmp_path))
    from classpro_tpu.tpu import skellam_dev as J

    from classpro_tpu_torch import skellam as S

    jt, jlf = J.build_packed_skellam(nmax)
    pt, plf = S.build_packed_skellam(nmax)
    assert pt.shape == (nmax + 1, S.NA_GRID + S.NB_GRID, 5)
    np.testing.assert_array_equal(pt.view(np.int64), jt.view(np.int64))
    np.testing.assert_array_equal(plf, jlf)


def test_sqrt_rn_is_correctly_rounded():
    """sqrt_rn matches numpy's IEEE sqrt bit for bit (torch's vectorised
    CPU sqrt is not always correctly rounded)."""
    from classpro_tpu_torch.skellam import sqrt_rn

    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 16384, 200000),
                        rng.uniform(0, 1e-3, 1000), [0.0, 64.0, 16384.0]])
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int64),
                                  np.sqrt(x).view(np.int64))
