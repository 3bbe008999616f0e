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


# Layouts the kernel's eight lanes per row, four rows per warp, find
# risky: R2 not a multiple of 4 or 8 (a warp with lanes past the last
# row), active masks with holes in every warp, rows of m = 1 and 2 beside
# rows of max_m in one warp (lanes stepping on, predicated, after their row
# ended), rows longer than 128 steps, and rows whose backpointers no
# longer fit the block's shared memory (max_m > 2458 on the card).
RAGGED = ("r97", "r101", "holes", "short_beside_long", "long_rows",
          "global_scratch")


def _ragged(case):
    """(planes, cov, active) of one ragged layout, made with numpy."""
    R2, max_m = {"r97": (97, 24), "r101": (101, 24), "holes": (96, 24),
                 "short_beside_long": (64, 40), "long_rows": (40, 160),
                 "global_scratch": (8, 2600)}[case]
    planes, cov = _random_planes(7 + RAGGED.index(case), R2=R2, max_m=max_m)
    rng = np.random.default_rng(RAGGED.index(case))
    active = None
    if case == "holes":
        act = rng.random(R2) < 0.6
        for g in range(R2 // 4):
            act[4 * g + g % 4] = False          # a hole in every warp
            act[4 * g + (g + 2) % 4] = True     # and a live row
        active = torch.from_numpy(act)
    if case in ("short_beside_long", "global_scratch"):
        m = np.tile([1, max_m, 2, max_m, 1, 2, max_m, 3], R2 // 8)
        planes = planes[:7] + (torch.from_numpy(m).to(torch.int64),) \
            + planes[8:]
    return planes, cov, active


def _tiny_params(device):
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram
    from classpro_tpu_torch.params import build_rel_params

    root = FIX / "tiny" / "reads"
    return build_rel_params(build_global_model(load_histogram(str(root))),
                            device)


@pytest.mark.parametrize("case", RAGGED)
def test_shim_matches_ref_on_ragged_warps(case):
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    P = _tiny_params("cpu")
    planes, cov, active = _ragged(case)
    want = rel_dp_ref(*planes, cov, P)
    rows = active if active is not None else None
    _assert_dp_close(kernels.rel_dp_host(*planes, cov, P, active=active),
                     want, rows=rows)


# rd::sat_i64 (csrc/rd_math.cuh, shared by K1 and K5) is XLA's float ->
# int64 cast: toward zero, saturating, NaN -> 0.  On the card it is the
# hardware conversion (__double2ll_rz), in the shim the portable form;
# both are held to that rule where they could differ: NaN of either sign,
# +-inf, +-2^63 and beyond, the largest doubles inside the range, -0.0.
_SAT_PROBE = r"""
#include "rd_math.cuh"
#ifdef __CUDACC__
__global__ void sat_kernel(const double* x, long long* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = rd::sat_i64(x[i]);
}
extern "C" int sat_probe(const double* x, long long* y, int n) {
  sat_kernel<<<(n + 63) / 64, 64>>>(x, y, n);
  return (int)cudaDeviceSynchronize();
}
#else
extern "C" int sat_probe(const double* x, long long* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = rd::sat_i64(x[i]);
  return 0;
}
#endif
"""
_SAT_BITS = (0x7ff8000000000000, 0xfff8000000000000, 0x7ff0000000000001,
             0xfff0000000000001)           # NaNs: quiet, negative, payloads


def _sat_inputs():
    x = np.array([math.inf, -math.inf, 2.0 ** 63, -2.0 ** 63,
                  2.0 ** 63 + 2048, -2.0 ** 63 - 2048, 2.0 ** 63 - 1024,
                  -2.0 ** 63 + 1024, 1e300, -1e300, 0.0, -0.0, 1.9999,
                  -1.9999, 123456789.75, -(2.0 ** 53) - 2.0, 4.9e-324],
                 dtype=np.float64)
    nans = np.array(_SAT_BITS, dtype=np.uint64).view(np.float64)
    return np.concatenate([x, nans])


def _xla_cast(x):
    if math.isnan(x):
        return 0
    if x >= 2.0 ** 63:
        return 2 ** 63 - 1
    if x < -2.0 ** 63:
        return -2 ** 63
    return int(x)                           # toward zero


@pytest.mark.parametrize("kind", ["host", pytest.param("cuda",
                                                       marks=pytest.mark.gpu)])
def test_sat_i64_is_the_xla_cast(kind, tmp_path):
    import ctypes
    import subprocess

    from classpro_tpu_torch import kernels

    if kind == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = tmp_path / "sat_probe.cu"
    src.write_text(_SAT_PROBE)
    so = tmp_path / f"libsat_{kind}.so"
    cmd = ([kernels._nvcc()] + kernels.NVCC_FLAGS if kind == "cuda"
           else ["g++"] + kernels.HOST_FLAGS)
    subprocess.run(cmd + ["-I", kernels._CSRC, str(src), "-o", str(so)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).sat_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    x = torch.from_numpy(_sat_inputs()).to(kind if kind == "cuda" else "cpu")
    y = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    assert fn(x.data_ptr(), y.data_ptr(), x.numel()) == 0
    assert y.cpu().tolist() == [_xla_cast(v) for v in _sat_inputs().tolist()]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RAGGED)
def test_cuda_kernel_matches_ref_on_ragged_warps(case):
    """The ragged layouts through the CUDA kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    P = _tiny_params("cuda")
    planes, cov, active = _ragged(case)
    planes = tuple(p.cuda() for p in planes)
    cov = cov.cuda()
    want = tuple(t.cpu() for t in rel_dp_ref(*planes, cov, P))
    got = kernels.rel_dp(*planes, cov, P,
                         active=active.cuda() if active is not None else None)
    torch.cuda.synchronize()
    _assert_dp_close(tuple(t.cpu() for t in got), want, rows=active)


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
