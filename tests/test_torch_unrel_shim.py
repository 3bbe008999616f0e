"""The sweep kernel on the card against the plain torch sweeps
(unrel_ref), and the wrapper's input checks.

The ``gpu`` tests run the kernel and skip without a card; on the CPU the
kernel's warp body (a warp's 32 lanes phase by phase) is held against the
plain version through its g++ shim, here on the warp layouts of
SWEEP_CASES and in test_torch_unrel.py on real chunks.  This file imports
no JAX, so it also runs on a machine that has only the port's
dependencies.  Its random planes (made with numpy: NaN and -inf
log-probabilities, zero and huge counts, neighbour counts whose
R-binomial index runs past the log-factorial head, steps that do not run)
feed test_torch_unrel.py too.  Tolerance: bit for bit.
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


# Layouts the kernel's four lanes per row, eight rows per warp, find
# risky: B not a multiple of 8 (a warp with lanes past the last row); rows
# with no active step (every interval a reliable fixed H/D, or no live
# step) beside rows of n = 0, 1, 2 and N; step indices outside [0, N) and
# in [n, N); rows past 1024 columns (more than one summary word per mask,
# and on the card past the block's shared memory) whose nearest neighbours
# lie more than 1024 columns away; and rows rich in reliable intervals
# assigned E or R, which the sweeps re-decide, so that they enter the H
# and D masks and leave them again and move later steps' neighbours.
SWEEP_CASES = ("b45", "no_active_steps", "idx_out_of_range", "n1100",
               "redecided")


def random_sweep_inputs(seed: int, P, B: int = 48, N: int = 40,
                        case: str | None = None):
    """Synthetic sweep arguments made with numpy, planes derived by the
    port's un_planes from random interval records; ``case`` (one of
    SWEEP_CASES) plants that layout."""
    from classpro_tpu_torch.alldev import un_planes
    from classpro_tpu_torch.numerics import LOGFACT

    if case is not None:
        B, N = {"b45": (45, 40), "n1100": (12, 1100)}.get(case, (B, N))
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
    if case == "no_active_steps":
        n[16:24] = N
        is_rel[16:20] = True                   # every interval fixed H/D
        asgn[16:20] = rng.integers(2, 4, (4, N))
        live[16:20] = True
        live[20:24] = False                    # no live step
        for r in range(16, 24):
            idx_asc[r] = rng.permutation(N)
            idx_desc[r] = rng.permutation(N)
    if case == "idx_out_of_range":
        for r in range(16, 32):
            t = rng.random(N) < 0.3
            idx_asc[r, t] = rng.choice([-7, -1, N, N + 5, n[r], N - 1],
                                       int(t.sum()))
            idx_desc[r, ::3] = rng.integers(-3, N + 3, len(range(0, N, 3)))
            live[r] = rng.random(N) < 0.8      # steps past n run too
    if case == "n1100":
        n[4:8] = N                             # sparse H/D, 1000+ apart
        is_rel[4:8] = False
        for r, c in zip(range(4, 8), ((3, 1090), (5, 1099), (1098,), (0,))):
            is_rel[r, list(c)] = True
            asgn[r] = 4
            asgn[r, list(c)] = rng.integers(2, 4, len(c))
            live[r] = True
            idx_asc[r] = rng.permutation(N)
            idx_desc[r] = rng.permutation(N)
    if case == "redecided":
        re_ = valid & (rng.random((B, N)) < 0.8)
        is_rel = is_rel | re_
        asgn = np.where(re_, rng.choice([0, 1, 0, 1, 2, 3], (B, N)),
                        asgn).astype(np.int32)
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


def _assert_planted(case, args, want, P):
    """The layout ``case`` plants is there in the inputs and shows in the
    plain version's output."""
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    is_rel, asgn0, live, n = args[0], args[1], args[7], args[8]
    B, N = asgn0.shape
    if case == "b45":
        assert B % 8 != 0
    if case == "no_active_steps":
        assert torch.equal(want[0][16:24].to(torch.int32), asgn0[16:24])
        assert bool(torch.isinf(want[1][16:24]).all())
    if case == "idx_out_of_range":
        idx = torch.cat([args[5], args[6]], 1)[16:32]
        lv = torch.cat([live, live], 1)[16:32]
        assert bool((lv & ((idx < 0) | (idx >= N))).any())
        assert bool((lv & (idx >= n[16:32, None]) & (idx < N)).any())
    if case == "n1100":
        assert N > 1024 and bool((is_rel[4:8].sum(1) <= 2).all())
        # the long rows are decided from neighbours 1000+ columns away
        assert int((want[0][4:8].to(torch.int32) != asgn0[4:8]).sum()) > 1000
    if case == "redecided":
        # reliable intervals assigned E/R enter the H and D masks ...
        er = is_rel & (asgn0 < 2) & (torch.arange(N)[None, :] < n[:, None])
        entered = er & (want[0] >= 2)
        assert int(entered.sum()) > 10
        # ... and move later steps' neighbours: kept out of the masks (no
        # longer reliable), they give another result
        other = unrel_sweeps_ref(is_rel & ~er, *args[1:], P)
        assert not torch.equal(other[0], want[0])


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_shim_matches_ref_on_sweep_layouts(case):
    """The g++ warp body against the plain version, bit for bit, on the
    layouts of SWEEP_CASES."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    PP = _torch_pp("tiny")
    args = random_sweep_inputs(11 + SWEEP_CASES.index(case), PP.rel,
                               case=case)
    want = unrel_sweeps_ref(*args, PP.unrel)
    _assert_planted(case, args, want, PP.unrel)
    assert_bit_equal(kernels.unrel_sweeps_host(*args, PP.unrel), want)


def test_geometry():
    """Four lanes per row, eight rows per one-warp block; the rows' state
    with a copy of their records in shared memory up to the block's 227
    KB, in the global scratch (without the copy) beyond."""
    from classpro_tpu_torch import kernels

    geo = kernels.unrel_geometry(256, 192, "host")
    assert geo == {"lanes_per_row": 4, "rows_per_warp": 8,
                   "threads_per_block": 32, "blocks": 32,
                   "smem_bytes": 8 * geo["row_bytes"],
                   "row_bytes": geo["row_bytes"]}
    assert 57 * 192 <= geo["row_bytes"] <= 58 * 192
    assert kernels.unrel_geometry(45, 40, "host")["blocks"] == 6
    assert kernels.unrel_geometry(8, 507, "host")["smem_bytes"] <= 227 * 1024
    far = kernels.unrel_geometry(12, 1100, "host")
    assert far["smem_bytes"] == 0 and 9 * 1100 <= far["row_bytes"] < 10 * 1100
    assert kernels.unrel_geometry(8, 508, "host")["smem_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_cuda_kernel_matches_ref_on_sweep_layouts(case):
    """The layouts of SWEEP_CASES through the kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.params import build_pipeline_params
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    gm, _, _ = _load("tiny", 1)
    PP = build_pipeline_params(gm, "cuda")
    args = [a.cuda() for a in random_sweep_inputs(
        11 + SWEEP_CASES.index(case), _torch_pp("tiny").rel, case=case)]
    want = unrel_sweeps_ref(*args, PP.unrel)
    got = kernels.unrel_sweeps(*args, PP.unrel)
    torch.cuda.synchronize()
    assert_bit_equal(tuple(t.cpu() for t in got),
                     tuple(t.cpu() for t in want))
