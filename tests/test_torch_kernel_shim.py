"""The DP kernel's per-row body (csrc/rel_dp_row.cuh) against the plain
torch DP (rel_ref), on the CPU.

nvcc compiles rel_dp_row.cuh into the CUDA kernel; here g++ compiles the
same header into a test-only host library (kernels.rel_dp_host), so the
kernel's logic (NaN-propagating maxima, discrete cutoffs, int64
truncations, the all-dead force flag, the rescue pass's active mask) is
tested without a card.  The card itself is the authority on the kernel:
the ``gpu`` test below runs it there and skips elsewhere.

Tolerance: asgn bit-equal on rows whose plain margin is >= 1e-5, rescue
equal, finite margins within 1e-9, the inf / 1e-30 patterns equal.
"""
import gzip
import json
import math
import pathlib

import numpy as np
import pytest
import torch

# the CPU path runs many small tensor ops: one intra-op thread per test
# worker (the workers share the cores, and idle OpenMP threads spin)
torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
EPS = 1e-5
TOL = 1e-9


def _load(fx: str, n: int | None = None):
    """(gm, seqs, profiles) of a fixture (the first n reads)."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    d = FIX / fx
    if fx in ("tie8339", "initkill21517"):
        rid = {"tie8339": 94, "initkill21517": 82}[fx]
        model = str(d / "rand.model") if fx == "initkill21517" else None
        gm = build_global_model(load_histogram(str(d / "reads")),
                                model_path=model)
        seq = gzip.open(d / f"read{rid}.fa.gz", "rt").read().split("\n")[1]
        return gm, [seq], [np.load(d / f"prof{rid}.npy")]
    args = {}
    if (d / "args.json").exists():
        args = json.loads((d / "args.json").read_text())
    gm = build_global_model(load_histogram(str(d / "reads")), **args)
    P = open_profiles(str(d / "reads"))
    reads = list(read_fastx(str(d / "reads.fasta.gz")))[:n]
    return gm, [r.seq for r in reads], [P.fetch(i) for i in range(len(reads))]


def _assert_dp_close(got, want, rows=None):
    a_g, d_g, m_g = got
    a_w, d_w, m_w = want
    if rows is None:
        rows = torch.ones_like(m_w, dtype=torch.bool)
    ok = rows & (m_w >= EPS)
    assert not bool(((a_g != a_w).any(1) & ok).any())
    m_g, m_w = m_g[rows], m_w[rows]
    assert torch.equal(torch.isinf(m_g), torch.isinf(m_w))
    assert torch.equal(m_g == 1e-30, m_w == 1e-30)
    fin = torch.isfinite(m_g) & torch.isfinite(m_w)
    if bool(fin.any()):
        assert float((m_g[fin] - m_w[fin]).abs().max()) <= TOL
    d_g, d_w = d_g[rows], d_w[rows]
    assert torch.equal(torch.isneginf(d_g), torch.isneginf(d_w))
    assert torch.equal(torch.isnan(d_g), torch.isnan(d_w))
    fin = torch.isfinite(d_g) & torch.isfinite(d_w)
    if bool(fin.any()):
        assert float((d_g[fin] - d_w[fin]).abs().max()) <= TOL


def check_shim_on_packs(fx, n=None):
    """The shim vs the plain DP on every chunk pack of a fixture, alone
    and inside the whole stage (rescue pass included)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import rel_pipeline, rel_planes
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    gm, seqs, profs = _load(fx, n)
    eng = TorchEngine(gm, device="cpu")
    P = eng.P
    checked = 0
    for lo in range(0, len(seqs), 200):
        pk = eng.stage_pack(seqs[lo:lo + 200], profs[lo:lo + 200])
        if pk is None:
            continue
        fb, ib, R, max_m = pk
        planes = rel_planes(torch.from_numpy(fb), torch.from_numpy(ib), P,
                            R, max_m)
        cov = P.gcov[None, :].expand(2 * R, 4).contiguous()
        _assert_dp_close(kernels.rel_dp_host(*planes, cov, P),
                         rel_dp_ref(*planes, cov, P))
        # the whole stage, rescue pass (active mask) included
        a_s, m_s, r_s = rel_pipeline(planes, P, max_m, kernels.rel_dp_host)
        a_r, m_r, r_r = rel_pipeline(planes, P, max_m, "ref")
        ok = m_r >= EPS
        assert not bool(((a_s != a_r).any(1) & ok).any())
        assert torch.equal(r_s, r_r)
        fin = torch.isfinite(m_s) & torch.isfinite(m_r)
        assert torch.equal(torch.isinf(m_s), torch.isinf(m_r))
        if bool(fin.any()):
            assert float((m_s[fin] - m_r[fin]).abs().max()) <= TOL
        checked += 2 * R
    assert checked > 0
    return r_r    # the last chunk's rescue flags


@pytest.mark.parametrize("fx,n", [("tiny", None), ("medium", 200),
                                  ("tie8339", None), ("initkill21517", None)])
def test_shim_matches_ref_on_packs(fx, n):
    check_shim_on_packs(fx, n)


# E emissions planted at the discrete cutoffs: +inf (the has_inf NaN
# poisoning), either side of the -745.13 exp-underflow cut, inside and at
# the edges of the (-745.2, -719.0) denormal flag band
SPECIAL_E = (math.inf, -745.05, -745.2, -725.0, -719.0, -719.5, -800.0)


def _random_planes(seed, R2=96, max_m=24):
    """Synthetic DP inputs made with numpy: plausible counts and
    positions, plus the extremes (zero and huge counts, -inf E
    emissions, single-interval rows, far-apart intervals whose Skellam
    term overflows, E emissions at the cutoffs)."""
    from classpro_tpu_torch.numerics import LOGFACT

    rng = np.random.default_rng(seed)
    m = rng.integers(1, max_m + 1, R2)
    m[:4] = [1, 2, max_m, max_m]
    m[8:8 + 3 * len(SPECIAL_E)] = max_m
    fwd = np.arange(R2) < R2 // 2
    gap = rng.integers(1, 400, (R2, max_m))
    gap[24:32] *= 200                      # lambda beyond the overflow
    pos = np.cumsum(gap, axis=1)
    length = rng.integers(1, 300, (R2, max_m))
    b = np.where(fwd[:, None], pos, pos[:, ::-1] + 5000)
    e = np.where(fwd[:, None], pos + length, pos[:, ::-1] + 5000 - length)
    scale = rng.choice([5, 20, 40, 80, 3000], (R2, 1))
    bcnt = np.maximum(rng.poisson(scale, (R2, max_m)), 0)
    ecnt = np.maximum(bcnt + rng.integers(-6, 7, (R2, max_m)), 0)
    bcnt[5, :] = 0
    ecnt[6, :] = 0
    max_cc = np.maximum(bcnt, ecnt) + rng.integers(0, 3, (R2, max_m))
    logpE = rng.uniform(-60.0, -0.5, (R2, max_m))
    logpE[rng.random((R2, max_m)) < 0.05] = -math.inf
    for k, v in enumerate(SPECIAL_E[:max(0, (R2 - 10) // 3)]):
        logpE[8 + 3 * k, 0] = v           # at step 0, a middle step and
        logpE[9 + 3 * k, rng.integers(1, max_m)] = v    # the last step
        logpE[10 + 3 * k, max_m - 1] = v
    plen = np.maximum(e.max(1), b.max(1)) + 50
    cov = np.tile([3, 76, 20, 38], (R2, 1))
    cov[R2 // 3:, :] = [2, 60, 15, 29]
    t = lambda a, dt=torch.int64: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    planes = (t(b), t(bcnt), t(e), t(ecnt), t(max_cc),
              t(LOGFACT[np.clip(bcnt, 0, 32767)], torch.float64),
              t(logpE, torch.float64), t(m), t(plen), t(fwd, torch.bool))
    return planes, t(cov)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_shim_matches_ref_on_random_planes(seed):
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.params import build_rel_params
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    root = FIX / "tiny" / "reads"
    P = build_rel_params(build_global_model(load_histogram(str(root))),
                         "cpu")
    planes, cov = _random_planes(seed)
    want = rel_dp_ref(*planes, cov, P)
    _assert_dp_close(kernels.rel_dp_host(*planes, cov, P), want)
    # the active mask limits the pass to its rows
    active = torch.from_numpy(np.random.default_rng(seed).random(
        cov.shape[0]) < 0.3)
    _assert_dp_close(kernels.rel_dp_host(*planes, cov, P, active=active),
                     want, rows=active)


def test_wrapper_checks_inputs():
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.params import build_rel_params

    root = FIX / "tiny" / "reads"
    P = build_rel_params(build_global_model(load_histogram(str(root))),
                         "cpu")
    planes, cov = _random_planes(9, R2=8, max_m=4)
    bad = list(planes)
    bad[1] = bad[1].to(torch.int32)
    with pytest.raises(ValueError, match="bcnt"):
        kernels.rel_dp_host(*bad, cov, P)
    with pytest.raises(ValueError, match="cov"):
        kernels.rel_dp_host(*planes, cov[:, :3].contiguous(), P)
    # on CPU tensors the main-path wrapper runs the plain version
    n0 = kernels.LAUNCHES["rel_dp"]
    _assert_dp_close(kernels.rel_dp(*planes, cov, P),
                     kernels.rel_dp_host(*planes, cov, P))
    assert kernels.LAUNCHES["rel_dp"] == n0


def test_ref_reports_the_table_records_it_reads():
    """rel_dp_ref's ``gathers`` (chip_smoke.py's byte bound) leaves the
    result unchanged and lists at most the 8 lookups of each live step,
    all inside the packed table."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.params import build_rel_params
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    root = FIX / "tiny" / "reads"
    P = build_rel_params(build_global_model(load_histogram(str(root))),
                         "cpu")
    planes, cov = _random_planes(5)
    gathers: list = []
    got = rel_dp_ref(*planes, cov, P, gathers=gathers)
    want = rel_dp_ref(*planes, cov, P)
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])
    idx = torch.cat(gathers)
    steps = int((planes[7] - 1).clamp(min=0).sum())
    assert 0 < idx.numel() <= 8 * steps
    assert int(idx.min()) >= 0 and int(idx.max()) < P.tab.shape[0] * P.tab.shape[1]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_cuda_kernel_matches_ref_on_card(seed):
    """The CUDA kernel against the plain version on the card, on the
    random planes with the planted cutoffs (the chip run's phase 3 holds
    it against the fixtures at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.params import build_rel_params
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    root = FIX / "tiny" / "reads"
    P = build_rel_params(build_global_model(load_histogram(str(root))),
                         "cuda")
    planes, cov = _random_planes(seed)
    planes = tuple(p.cuda() for p in planes)
    cov = cov.cuda()
    want = tuple(t.cpu() for t in rel_dp_ref(*planes, cov, P))
    n0 = kernels.LAUNCHES["rel_dp"]
    got = kernels.rel_dp(*planes, cov, P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rel_dp"] == n0 + 1
    _assert_dp_close(tuple(t.cpu() for t in got), want)
    active = torch.from_numpy(np.random.default_rng(seed).random(
        cov.shape[0]) < 0.3)
    got = kernels.rel_dp(*planes, cov, P, active=active.cuda())
    torch.cuda.synchronize()
    _assert_dp_close(tuple(t.cpu() for t in got), want, rows=active)
