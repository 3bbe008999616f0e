"""Randomized differential test of the host rel steps that follow the DP.

The port's ``rel.demote_host`` (candidate-row demotions) and
``rel.reconcile_fwbw`` are held against the JAX package's host versions
and against its full-plane device formula ``_demotes_dev``, on random
batches made with numpy whose rows are biased into the rare gated
branches: no-H rescue rows, all-H rows, >=70%-H rows, backward-row
reversal, and exact hdrr ties.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest

ERROR, REPEAT, HAPLO, DIPLO = 0, 1, 2, 3


def _batch(rng, R=8, max_m=12):
    m = rng.integers(0, max_m + 1, R)
    gH, gD = int(rng.integers(10, 30)), 0
    gD = 2 * gH - int(rng.integers(-2, 3))
    b = np.zeros((R, max_m), np.int32)
    e = np.ones((R, max_m), np.int32)
    ccb = np.ones((R, max_m), np.int32)
    cce = np.ones((R, max_m), np.int32)
    rel2 = np.zeros((2 * R, max_m), np.int8)
    for j in range(R):
        n = int(m[j])
        starts = np.cumsum(rng.integers(1, 60, n))
        b[j, :n] = starts
        e[j, :n] = starts + rng.integers(1, 50, n)
        centre = rng.choice([gH, gD, (gH + gD) // 2, 3 * gH])
        ccb[j, :n] = np.maximum(rng.integers(centre - 4, centre + 5, n), 1)
        cce[j, :n] = np.maximum(ccb[j, :n] + rng.integers(-3, 4, n), 1)
        if rng.random() < 0.25:    # mean exactly between gH and gD: ties
            ccb[j, :n] = cce[j, :n] = (gH + gD) // 2
        for r in (j, R + j):
            kind = rng.integers(0, 4)
            if kind == 0:      # all H
                row = np.full(n, HAPLO)
            elif kind == 1:    # >= 70% H, rest D/R
                row = np.where(rng.random(n) < 0.8, HAPLO,
                               rng.choice([DIPLO, REPEAT], n))
            elif kind == 2:    # no H: D with some R/E
                row = rng.choice([DIPLO, DIPLO, REPEAT, ERROR], n)
            else:
                row = rng.integers(0, 4, n)
            rel2[r, :n] = row
    rescue = rng.random(2 * R) < 0.5
    return rel2, rescue, b, e, ccb, cce, m.astype(np.int32), gH, gD


def _demotes_dev_ref(rel2, rescue, b, e, ccb, cce, m, gH, gD):
    """The JAX full-plane device formula on the same batch."""
    from classpro_tpu.tpu.device_pipeline import _demotes_dev

    R, max_m = b.shape
    cols = np.arange(max_m)[None, :]
    mv = m.astype(np.int64)
    flip = np.where(cols < mv[:, None], mv[:, None] - 1 - cols, cols)
    rev = lambda a: np.take_along_axis(a, flip, axis=1)
    b64, e64 = b.astype(np.int64), e.astype(np.int64)
    bpos = np.concatenate([b64, rev(e64) - 1])
    epos = np.concatenate([e64 - 1, rev(b64)])
    bcnt = np.concatenate([ccb, rev(cce)]).astype(np.int64)
    ecnt = np.concatenate([cce, rev(ccb)]).astype(np.int64)
    m2 = np.concatenate([mv, mv])
    inb = cols < m2[:, None]
    g = lambda v: jnp.full((2 * R,), v, jnp.int64)
    out = _demotes_dev(jnp.asarray(rel2.astype(np.int32)),
                       jnp.asarray(rescue), jnp.asarray(inb),
                       jnp.asarray(np.abs(epos - bpos) + 1),
                       jnp.asarray(bcnt), jnp.asarray(ecnt),
                       jnp.asarray(m2), g(gH), g(gD))
    return np.asarray(out).astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_demote_and_reconcile_match_jax(seed):
    from classpro_tpu.tpu import device_pipeline as J

    from classpro_tpu_torch import rel as T

    rng = np.random.default_rng(seed)
    fired = 0
    for _ in range(150):
        rel2, rescue, b, e, ccb, cce, m, gH, gD = _batch(rng)
        got = T.demote_host(rel2, rescue, b, e, ccb, cce, m, gH, gD)
        want = J.demote_host(rel2, rescue, b, e, ccb, cce, m, gH, gD)
        np.testing.assert_array_equal(got, want)
        if seed == 0:   # the device formula (jit compiles per shape)
            np.testing.assert_array_equal(
                got, _demotes_dev_ref(rel2, rescue, b, e, ccb, cce, m,
                                      gH, gD))
        fired += int((got != rel2).any())
        np.testing.assert_array_equal(
            T.reconcile_fwbw(got, ccb, cce, m),
            J.reconcile_fwbw(got, ccb, cce, m))
    assert fired > 30   # the demotions really flip rows
