"""The sweep kernel on the card against the plain torch sweeps
(unrel_ref), and the wrapper's input checks.

The ``gpu`` test runs the kernel and skips without a card; on the CPU the
kernel's per-row body is held against the plain version through its g++
shim in test_torch_unrel.py.  This file imports no JAX, so it also runs
on a machine that has only the port's dependencies.  Its random planes
(made with numpy: NaN and -inf log-probabilities, zero and huge counts,
neighbour counts whose R-binomial index runs past the log-factorial head,
steps that do not run) feed test_torch_unrel.py too.  Tolerance: bit for
bit.
"""
import functools
import math

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _torch_pp(fx: str):
    from classpro_tpu_torch.params import build_pipeline_params

    gm, _, _ = _load(fx, 1)
    return build_pipeline_params(gm, "cpu")


def random_sweep_inputs(seed: int, P, B: int = 48, N: int = 40):
    """Synthetic sweep arguments made with numpy, planes derived by the
    port's un_planes from random interval records."""
    from classpro_tpu_torch.alldev import un_planes
    from classpro_tpu_torch.numerics import LOGFACT

    rng = np.random.default_rng(seed)
    n = rng.integers(0, N + 1, B).astype(np.int32)
    n[:4] = [0, 1, 2, N]
    cols = np.arange(N)[None, :]
    valid = cols < n[:, None]
    gap = rng.integers(1, 400, (B, N))
    gap[8:12] *= 300                       # far apart: huge Skellam lambda
    b = np.cumsum(gap, axis=1).astype(np.int32)
    e = (b + rng.integers(1, 300, (B, N))).astype(np.int32)
    scale = rng.choice([0, 5, 20, 40, 80, 3000], (B, 1))
    cb = rng.poisson(np.maximum(scale, 1), (B, N)).astype(np.int32)
    cb[scale[:, 0] == 0] = 0
    ce = np.maximum(cb + rng.integers(-6, 7, (B, N)), 0).astype(np.int32)
    ccb = np.maximum(cb + rng.integers(-2, 3, (B, N)), 0).astype(np.int32)
    cce = np.maximum(ce + rng.integers(-2, 3, (B, N)), 0).astype(np.int32)
    pe = rng.uniform(-60.0, -0.5, (B, N))
    peob = rng.uniform(-40.0, -0.5, (B, N))
    peoe = rng.uniform(-40.0, -0.5, (B, N))
    for a in (pe, peob, peoe):
        a[rng.random((B, N)) < 0.08] = -math.inf
        a[rng.random((B, N)) < 0.02] = math.nan
    is_rel = (rng.random((B, N)) < 0.35) & valid
    asgn = np.where(is_rel, rng.integers(0, 4, (B, N)), 4).astype(np.int32)
    idx_asc = np.zeros((B, N), np.int32)
    idx_desc = np.zeros((B, N), np.int32)
    for r in range(B):
        idx_asc[r, :n[r]] = rng.permutation(n[r])
        idx_desc[r, :n[r]] = rng.permutation(n[r])
    live = valid.copy()
    live[12:16] &= rng.random(live[12:16].shape) < 0.5   # steps not run
    t = torch.from_numpy
    U = {"b": t(b), "e": t(e), "cb": t(cb), "ce": t(ce), "ccb": t(ccb),
         "cce": t(cce), "pe": t(pe), "peob": t(peob), "peoe": t(peoe),
         "lf_cb": t(LOGFACT[np.minimum(cb, 32767)]),
         "lf_ce": t(LOGFACT[np.minimum(ce, 32767)])}
    P13, packL, packR = un_planes(U, P)
    return (t(is_rel), t(asgn), P13, packL, packR, t(idx_desc), t(idx_asc),
            t(live), t(n))


def assert_bit_equal(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int64), want[1].view(torch.int64))


def test_wrapper_checks_inputs():
    from classpro_tpu_torch import kernels

    PP = _torch_pp("tiny")
    args = list(random_sweep_inputs(7, PP.rel, B=6, N=8))
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="asgn"):
        kernels.unrel_sweeps_host(*bad, PP.unrel)
    bad = list(args)
    bad[8] = bad[8][:3]
    with pytest.raises(ValueError, match="n:"):
        kernels.unrel_sweeps_host(*bad, PP.unrel)
    # on CPU tensors the wrapper runs the plain version, uncounted
    n0 = kernels.LAUNCHES["unrel_sweeps"]
    assert_bit_equal(kernels.unrel_sweeps(*args, PP.unrel),
                     kernels.unrel_sweeps_host(*args, PP.unrel))
    assert kernels.LAUNCHES["unrel_sweeps"] == n0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cuda_kernel_matches_ref_on_card(seed):
    """The sweep kernel against the plain version on the card, bit for
    bit, on the random planes (chip_smoke.py holds it against every
    medium chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.params import build_pipeline_params
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    gm, _, _ = _load("tiny", 1)
    PP = build_pipeline_params(gm, "cuda")
    args = [a.cuda() for a in random_sweep_inputs(seed, _torch_pp("tiny").rel)]
    want = unrel_sweeps_ref(*args, PP.unrel)
    n0 = kernels.LAUNCHES["unrel_sweeps"]
    got = kernels.unrel_sweeps(*args, PP.unrel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["unrel_sweeps"] == n0 + 1
    assert_bit_equal(tuple(t.cpu() for t in got),
                     tuple(t.cpu() for t in want))
