"""The slice as a whole: ``rel.rel_glued`` and ``alldev.classify_glued``
(what ``rel_only``'s graph replays and ``classify_batch`` runs on a card)
composed of the glue kernels' g++ shims and the DP and sweep kernels'
shims (``rel_dp_first_host``, ``rel_dp_host``, ``rel_dp_rescue_host``,
``rel_dp_pack_host``, ``unrel_sweeps_host``), as the card runs them (two
launches per main-path chunk, the first with its prologue; five per
all-device chunk, the sweeps' with the gate tail that packs the rows
with their guard flags), against the JAX package's
``rel_only_dev`` and
``classify_batch_dev`` on the CPU and against the port's plain glue
around the same DP and sweep shims.

Inputs: the chunk packs of tiny, of the first 200 reads of medium, of
branch/search9 (rows the rescue re-runs) and of branch/psum0 (the
all-dead row), at batch 200.

Tolerance: against the plain glue around the same shims, bit for bit.
Against JAX (whose DP interpolates the same table in another order):
``rel_only``'s assignments bit-equal on the rows whose JAX margin is >=
1e-5, rescue flags equal, risky flags equal except where the margin lies
within 1e-9 of 1e-5 (test_torch_rel.py's rule); ``classify_batch``'s
flags equal and its assignments bit-equal on the reads neither flags.
"""
import types

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from test_torch_alldev import _chunks
from test_torch_kernel_shim import _load
from test_torch_rel import _jax_gm, _jax_params
from test_torch_unrel import _jax_pp
from test_torch_unrel_shim import _torch_pp

torch.set_num_threads(1)

EPS = 1e-5
TOL = 1e-9
SLICE = [("tiny", None), ("medium", 200), ("branch/search9", None),
         ("branch/psum0", None)]


def _shims():
    """The kernels' g++ shims under the kernels module's names."""
    from classpro_tpu_torch import kernels

    return types.SimpleNamespace(
        rel_prep=kernels.rel_prep_host, rel_dp=kernels.rel_dp_host,
        rel_dp_first=kernels.rel_dp_first_host,
        rel_dp_rescue=kernels.rel_dp_rescue_host,
        rel_dp_pack=kernels.rel_dp_pack_host,
        rel_settle=kernels.rel_settle_host,
        unrel_sweeps=kernels.unrel_sweeps_host)


@pytest.mark.parametrize("fx,n", SLICE)
def test_rel_only_from_shims_matches_jax(fx, n):
    from classpro_tpu.tpu.device_pipeline import rel_only_dev

    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import rel_glued, rel_only, unpack_out

    gm, seqs, profs = _load(fx, n)
    eng = TorchEngine(gm, batch_size=200, device="cpu")
    pp = _jax_params(_jax_gm(fx))
    ops = _shims()
    rows = rescued = 0
    for lo in range(0, len(seqs), 200):
        pk = eng.stage_pack(seqs[lo:lo + 200], profs[lo:lo + 200])
        if pk is None:
            continue
        fb, ib, R, max_m = pk
        tfb, tib = torch.from_numpy(fb), torch.from_numpy(ib)
        got = rel_glued(tfb, tib, eng.P, R, max_m, ops).numpy()
        # the plain glue around the same DP shim: every byte
        plain = rel_only(tfb, tib, eng.P, R, max_m,
                         impl=kernels.rel_dp_host).numpy()
        np.testing.assert_array_equal(got, plain)
        want = np.asarray(rel_only_dev(fb, ib, pp, R=R, max_m=max_m))
        g_a, g_risky, g_res, _ = unpack_out(got, max_m)
        w_a, w_risky, w_res, w_mm = unpack_out(want, max_m)
        ok = w_mm.astype(np.float64) >= EPS
        np.testing.assert_array_equal(g_a[ok], w_a[ok])
        np.testing.assert_array_equal(g_res, w_res)
        near = np.abs(w_mm.astype(np.float64) - EPS) < TOL
        np.testing.assert_array_equal(g_risky[~near], w_risky[~near])
        rows += 2 * R
        rescued += int(g_res.sum())
    assert rows > 0
    if fx == "branch/search9":
        assert rescued > 0


@pytest.mark.parametrize("fx,n", SLICE)
def test_classify_batch_from_shims_matches_jax(fx, n):
    from classpro_tpu.tpu.device_pipeline import classify_batch_dev

    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import (classify_batch, classify_glued,
                                           pack_flags)

    pp, PP = _jax_pp(fx), _torch_pp(fx)
    ops = _shims()
    reads = 0
    for (fb, ib, dims, meta), _ in _chunks(fx, n):
        tfb, tib = torch.from_numpy(fb), torch.from_numpy(ib)
        packed = classify_glued(tfb, tib, PP, *dims, ops)
        # the plain glue around the same DP and sweep shims: every byte
        p_out, p_flags = classify_batch(
            tfb, tib, PP, *dims,
            impl=(kernels.rel_dp_host, kernels.unrel_sweeps_host))
        assert torch.equal(packed, pack_flags(p_out, p_flags))
        out, flags = packed[:, :-1].view(torch.int8), packed[:, -1] != 0
        jo, jf = (np.asarray(x) for x in classify_batch_dev(fb, ib, pp,
                                                            *dims))
        out, flags = out.numpy(), flags.numpy()
        np.testing.assert_array_equal(flags, jf)
        np.testing.assert_array_equal(out[~flags], jo[~flags])
        reads += len(meta[0])
    assert reads > 0
