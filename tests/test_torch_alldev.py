"""The all-device path (alldev.classify_batch) against the JAX package's
``classify_batch_dev`` and its helpers and the port's host rel steps, on
the CPU.

* ``demotes_dev`` == JAX ``_demotes_dev`` == the port's ``demote_host`` on
  random batches biased into the gated branches, and on a row of m = 10
  intervals with 7 H (on the 70% line) and with 6 H.
* ``reconcile_dev`` == the port's host ``reconcile_fwbw`` on every row;
  JAX ``_reconcile_dev`` is compared on the rows where it agrees with the
  host version (its XLA division may flip an exact hdrr tie).
* ``pack_chunk`` == JAX ``pack_chunk`` blob for blob; ``classify_batch``
  == JAX ``classify_batch_dev`` on the reads neither flags, flags equal;
  with the kernels' g++-built bodies it equals the plain versions, and
  ``classify_glued`` on those bodies (the sweeps with their gate tail)
  gives JAX's flags.
The engine's bytes are in test_torch_alldev_engine.py and
test_torch_alldev_branch*.py.  Tolerance: exact equality everywhere
(integer decisions).
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_host_steps import _batch, _demotes_dev_ref
from test_torch_kernel_shim import _load
from test_torch_unrel import _jax_pp
from test_torch_unrel_shim import _torch_pp

torch.set_num_threads(1)

ERROR, REPEAT, HAPLO, DIPLO = 0, 1, 2, 3


def _scan_planes(b, e, ccb, cce, m):
    """The scan-order planes of forward-order records (fw rows, then the
    bw rows reversed within m), int64 torch."""
    R, max_m = b.shape
    cols = np.arange(max_m)[None, :]
    mv = m.astype(np.int64)
    flip = np.where(cols < mv[:, None], mv[:, None] - 1 - cols, cols)
    rev = lambda a: np.take_along_axis(a, flip, axis=1)
    b64, e64 = b.astype(np.int64), e.astype(np.int64)
    t = torch.from_numpy
    return (t(np.concatenate([b64, rev(e64) - 1])),
            t(np.concatenate([e64 - 1, rev(b64)])),
            t(np.concatenate([ccb, rev(cce)]).astype(np.int64)),
            t(np.concatenate([cce, rev(ccb)]).astype(np.int64)),
            t(np.concatenate([mv, mv])))


def _demotes(rel2, rescue, b, e, ccb, cce, m, gH, gD):
    from classpro_tpu_torch.alldev import demotes_dev

    bpos, epos, bcnt, ecnt, m2 = _scan_planes(b, e, ccb, cce, m)
    inb = torch.arange(b.shape[1])[None, :] < m2[:, None]
    out = demotes_dev(torch.from_numpy(rel2.astype(np.int64)),
                      torch.from_numpy(rescue), inb,
                      torch.abs(epos - bpos) + 1, bcnt, ecnt, m2,
                      torch.tensor(gH), torch.tensor(gD))
    return out.numpy().astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1])
def test_demotes_dev_matches_jax_and_host(seed):
    from classpro_tpu_torch.rel import demote_host

    rng = np.random.default_rng(seed)
    fired = 0
    for _ in range(60):
        args = _batch(rng)
        got = _demotes(*args)
        np.testing.assert_array_equal(got, demote_host(*args))
        np.testing.assert_array_equal(got, _demotes_dev_ref(*args))
        fired += int((got != args[0]).any())
    assert fired > 10


def test_demotes_70_percent_h_row():
    """m = 10 with 7 H sits on the 70% line: 10 * 0.7 rounds to 7.0 in
    float64 (0.7's double lies below 0.7), so the row demotes H->D, D->R
    when its H means sit nearer gD; with 6 H it does not.  The port takes
    the product in float64 as JAX does (torch's int64 * 0.7 is float32;
    the two round to the same side of every integer for m <= 200000)."""
    from classpro_tpu_torch.rel import demote_host

    max_m, gH, gD = 12, 20, 40
    b = np.zeros((1, max_m), np.int32)
    b[0, :10] = np.arange(10) * 100
    e = b + 50
    ccb = np.full((1, max_m), 39, np.int32)
    cce = ccb.copy()
    m = np.array([10], np.int32)
    row = np.array([HAPLO] * 7 + [DIPLO] * 3 + [0, 0], np.int8)
    rescue = np.zeros(2, bool)
    assert (torch.tensor([10]) * 0.7).dtype == torch.float32
    for n_h in (7, 6):
        rel2 = np.stack([row, row])
        rel2[:, n_h:10] = DIPLO
        got = _demotes(rel2, rescue, b, e, ccb, cce, m, gH, gD)
        np.testing.assert_array_equal(
            got, demote_host(rel2, rescue, b, e, ccb, cce, m, gH, gD))
        np.testing.assert_array_equal(
            got, _demotes_dev_ref(rel2, rescue, b, e, ccb, cce, m, gH, gD))
        if n_h == 7:
            assert (got[:, :7] == DIPLO).all()
            assert (got[:, 7:10] == REPEAT).all()
        else:
            np.testing.assert_array_equal(got, rel2)


def test_reconcile_dev_equals_host_on_every_row():
    from classpro_tpu.tpu.device_pipeline import _reconcile_dev

    from classpro_tpu_torch.alldev import reconcile_dev
    from classpro_tpu_torch.rel import demote_host, reconcile_fwbw

    rng = np.random.default_rng(5)
    rows = jax_differs = took_bw = 0
    for _ in range(120):
        args = _batch(rng)
        _, _, b, e, ccb, cce, m = args[:7]
        rel2 = demote_host(*args)
        R, max_m = b.shape
        _, _, bcnt, ecnt, m2 = _scan_planes(b, e, ccb, cce, m)
        fwd = torch.arange(2 * R) < R
        got = reconcile_dev(torch.from_numpy(rel2.astype(np.int64)), m2,
                            bcnt, ecnt, fwd, R, max_m).numpy()
        want = reconcile_fwbw(rel2, ccb, cce, m)
        np.testing.assert_array_equal(got, want)
        j = np.asarray(_reconcile_dev(
            jnp.asarray(rel2.astype(np.int32)), jnp.asarray(m2.numpy()),
            jnp.asarray(bcnt.numpy()), jnp.asarray(ecnt.numpy()),
            jnp.asarray(fwd.numpy()), R, max_m))
        agree = (j == want).all(1)
        np.testing.assert_array_equal(got[agree], j[agree])
        rows += R
        jax_differs += int((~agree).sum())
        took_bw += int((want != rel2[:R]).any(1).sum())
    print(f"reconcile: {rows} rows, JAX _reconcile_dev differs from the "
          f"host on {jax_differs}")
    assert took_bw > 20       # the bw row wins on enough rows


def _jax_pack(rows, ivs, plens):
    from classpro_tpu.tpu.engine import pack_chunk

    return pack_chunk(rows, ivs, None, plens)


def _chunks(fx, n=None, B=200):
    """(port pack, JAX pack) of every chunk of ``fx``."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.pack import pack_chunk

    gm, seqs, profs = _load(fx, n)
    eng = TorchEngine(gm, device="cpu")
    for lo in range(0, len(seqs), B):
        st = eng._stage(seqs[lo:lo + B], profs[lo:lo + B])
        slab, slot, n_out = st["slab"], st["slot"], st["n_out"]
        rows = [r for r in range(len(st["g"])) if n_out[r] > 0]
        ivs = [slab[r * slot: r * slot + int(n_out[r])]
               for r in range(len(st["g"]))]
        plens = [len(st["profiles"][i]) for i in st["g"]]
        yield pack_chunk(rows, ivs, plens), _jax_pack(rows, ivs, plens)


@pytest.mark.parametrize("fx,n", [("tiny", None), ("medium", 200)])
def test_classify_batch_matches_jax(fx, n):
    from classpro_tpu.tpu.device_pipeline import classify_batch_dev

    from test_torch_glue_slice import _shims

    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import classify_batch, classify_glued

    pp, PP = _jax_pp(fx), _torch_pp(fx)
    for (fb, ib, dims, meta), (jfb, jib, jdims, _) in _chunks(fx, n):
        np.testing.assert_array_equal(ib, jib)
        np.testing.assert_array_equal(fb.view(np.int64), jfb.view(np.int64))
        assert dims == jdims
        jo, jf = (np.asarray(x) for x in classify_batch_dev(fb, ib, pp,
                                                            *dims))
        out, flags = classify_batch(torch.from_numpy(fb),
                                    torch.from_numpy(ib), PP, *dims)
        out, flags = out.numpy(), flags.numpy()
        np.testing.assert_array_equal(flags, jf)
        ok = ~flags
        np.testing.assert_array_equal(out[ok], jo[ok])
        assert len(meta[0]) > 0
        # the kernels' bodies (g++ shims) give the plain versions' result
        so, sf = classify_batch(torch.from_numpy(fb), torch.from_numpy(ib),
                                PP, *dims, impl=(kernels.rel_dp_host,
                                                 kernels.unrel_sweeps_host))
        np.testing.assert_array_equal(so.numpy(), out)
        np.testing.assert_array_equal(sf.numpy(), flags)
        # the card's five launches as shims: the sweeps' gate tail writes
        # JAX's flags and, on the reads neither flags, its assignments
        packed = classify_glued(torch.from_numpy(fb), torch.from_numpy(ib),
                                PP, *dims, _shims()).numpy()
        np.testing.assert_array_equal(packed[:, -1] != 0, jf)
        np.testing.assert_array_equal(packed[:, :-1].view(np.int8)[ok],
                                      jo[ok])
