"""Global estimation: coverage peaks, R-threshold, error-model tables.

Computed once per dataset and replicated read-only to every worker/device,
mirroring the reference's main-thread precomputation (ClassPro.c:543-554):

* (H,D) coverage from the k-mer count histogram (hist.c:28-105)
* ``GLOBAL_COV`` = [1, R-thres, H, D] and ``DR_RATIO`` (ClassPro.c:544-548)
* context-dependent error rates ``pe[t][l]`` and count-change threshold
  tables ``cthres[t][l][cout][ThresT][Etype]`` (wall.c:120-244)

In a multi-host setting the histogram itself is an all-reduce of per-host
partial histograms; everything downstream of the histogram is
deterministic and identical on every host.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from classpro_tpu_torch.constants import (
    Ctype,
    Defaults,
    Etype,
    State,
    ThresT,
    N_CTYPE,
    N_ETYPE,
    N_THRES,
)
from classpro_tpu_torch.io.fastk import Histogram
from classpro_tpu_torch.numerics import logp_binom_pre, plus_sigma


def _c_round(x: float) -> int:
    """C round(): half away from zero (Python round is banker's)."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def estimate_coverage(hist: Histogram, coverage: int = 0,
                      verbose: bool = False) -> tuple[int, int]:
    """(H, D) k-mer coverage from the global histogram
    (process_global_hist, hist.c:28-105).

    ``coverage > 0`` overrides with (coverage >> 1, coverage) (hist.c:44-48).
    """
    if coverage > 0:
        return coverage >> 1, coverage

    inst = hist.instance_counts()
    low, high = hist.low, hist.high

    def h(i: int) -> int:
        return int(inst[i - low])

    maxcnt, maxpk = 0, 0
    for i in range(max(2, low), min(1000, high)):
        if h(i - 1) < h(i) and h(i) > h(i + 1) and maxpk < h(i):
            maxcnt, maxpk = i, h(i)
    if maxcnt < 10:
        raise ValueError(
            "Could not find any peak count >= 10 in the histogram; "
            "use an explicit coverage (-c)")

    m = maxcnt / 2.0
    s = math.sqrt(m)
    lmaxcnt = lmaxpk = 0
    is_lpeak = 0
    for i in range(_c_round(m - s), _c_round(m + s) + 1):
        if lmaxpk < h(i):
            lmaxcnt, lmaxpk = i, h(i)
            is_lpeak = 1 if (h(i - 1) < h(i) and h(i) > h(i + 1)) else 0

    m = maxcnt * 2.0
    s = math.sqrt(m)
    rmaxcnt = rmaxpk = 0
    is_rpeak = 0
    for i in range(_c_round(m - s), _c_round(m + s) + 1):
        if rmaxpk < h(i):
            rmaxcnt, rmaxpk = i, h(i)
            is_rpeak = 1 if (h(i - 1) < h(i) and h(i) > h(i + 1)) else 0

    if lmaxpk > rmaxpk:  # maxcnt is the D peak
        dcov = maxcnt
        hcov = lmaxcnt if is_lpeak else (maxcnt >> 1)
    else:  # maxcnt is the H peak
        hcov = maxcnt
        dcov = rmaxcnt if is_rpeak else (maxcnt << 1)
    return hcov, dcov


@dataclasses.dataclass
class ErrorModel:
    """Per-context-type error rates + count-change thresholds.

    ``pe[t][l]``: error probability for a length-l run of unit length t+1
    (wall.c:141-143 default: 0.002*l^2 + 0.002).
    ``cthres[t, l, cout, s, e]``: the cin threshold table
    (calc_init_thres, wall.c:167-244); entries for l > lmax[t] or
    cout >= cmax are unused.
    """

    lmax: np.ndarray      # (N_CTYPE,) int — 20, 10, 6
    pe: np.ndarray        # (N_CTYPE, max_lmax+1) float64
    cthres: np.ndarray    # (N_CTYPE, max_lmax+1, cmax, N_THRES, N_ETYPE) int16
    cmax: int
    hc_erate: float       # emodel[HP].pe[1] (wall.c:180)


def _default_pe(defaults: Defaults) -> tuple[np.ndarray, np.ndarray]:
    lmax = np.array([defaults.max_n_lc // (t + 1) for t in range(N_CTYPE)])
    pe = np.zeros((N_CTYPE, int(lmax.max()) + 1))
    for t in range(N_CTYPE):
        for l in range(1, lmax[t] + 1):
            pe[t, l] = 0.002 * l * l + 0.002
    return lmax, pe


def _quadfit(x: np.ndarray, y: np.ndarray) -> list[float]:
    """Degree-2 least squares via normal equations + Gaussian elimination
    with partial pivoting, replicating our GSL-free reference patch's
    `polynomialfit` operation-for-operation (the oracle binary is built
    with that patch, so -M runs stay bit-comparable)."""
    degree = 3
    A = [[0.0] * degree for _ in range(degree)]
    b = [0.0] * degree
    for i in range(len(x)):
        px = [1.0, 0.0, 0.0]
        for j in range(1, degree):
            px[j] = px[j - 1] * x[i]
        for j in range(degree):
            b[j] += px[j] * y[i]
            for k in range(degree):
                A[j][k] += px[j] * px[k]
    for j in range(degree):
        piv = j
        for k in range(j + 1, degree):
            if abs(A[k][j]) > abs(A[piv][j]):
                piv = k
        if piv != j:
            A[j], A[piv] = A[piv], A[j]
            b[j], b[piv] = b[piv], b[j]
        for k in range(j + 1, degree):
            f = A[k][j] / A[j][j]
            for l in range(j, degree):
                A[k][l] -= f * A[j][l]
            b[k] -= f * b[j]
    coef = [0.0] * degree
    for j in range(degree - 1, -1, -1):
        s = b[j]
        for k in range(j + 1, degree):
            s -= A[j][k] * coef[k]
        coef[j] = s / A[j][j]
    return coef


def _himodel_pe(path: str, defaults: Defaults) -> tuple[np.ndarray, np.ndarray]:
    """Parse a HIsim error-model file and fit degree-2 polynomials
    (load_himodel, wall.c:55-115).

    Layout: int32 kmer; 0x4000 heptamer E_Rates records (11 float32 each:
    all, ins, op[9]); then for each unit length u in 1..3, krange * 4^u
    M_Rates records (7 float32: all, op[6]) where krange = kmer/2 - 6.
    """
    lmax, pe = _default_pe(defaults)
    with open(path, "rb") as f:
        (kmer,) = struct.unpack("<i", f.read(4))
        krange = kmer // 2 - 6
        f.read(0x4000 * 11 * 4)  # heptamer table (unused by the pe fit)
        for t in range(N_CTYPE):
            ulen = t + 1
            n = 1 << (2 * ulen)
            mics = np.frombuffer(f.read(4 * 7 * krange * n), dtype="<f4")
            mics = mics.reshape(n, krange, 7)[:, :, 0]  # .all field
            # y[j-1] = mean over units of rate at run length j (cols are
            # indexed from 2*ulen in the C table; col j*ulen maps to
            # mics[:, j*ulen - 2*ulen])
            x = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
            y = np.zeros(5)
            y[0] = 0.002
            for j in range(2, 6):
                col = j * ulen - 2 * ulen
                # sequential accumulation in unit order (the C loop's
                # addition order, wall.c:92-99 — pairwise numpy sums can
                # differ in the last ulps)
                s = 0.0
                cnt = 0
                for v in mics[:, col]:
                    if v > 0.0:
                        s += float(v)
                        cnt += 1
                # degenerate model column (no positive rates): the C code
                # divides 0.0 by 0 and silently propagates NaN into the
                # polyfit (wall.c:99); reproduce that instead of raising
                y[j - 1] = s / cnt if cnt else float("nan")
            coef = _quadfit(x, y)  # ascending order
            for l in range(1, lmax[t] + 1):
                pe[t, l] = coef[0] + coef[1] * l + coef[2] * l * l
    return lmax, pe


def build_error_model(cmax: int, defaults: Defaults,
                      model_path: str | None = None) -> ErrorModel:
    """calc_init_thres (wall.c:167-244): for every (ctype, run length,
    outer count), the cin values at which the binomial tail crosses the
    INIT/FINAL x SELF/OTHERS thresholds."""
    if model_path is None:
        lmax, pe = _default_pe(defaults)
    else:
        lmax, pe = _himodel_pe(model_path, defaults)
    max_lmax = int(lmax.max())
    pe_thres = [
        [defaults.pe_thres_init_self, defaults.pe_thres_init_others],
        [defaults.pe_thres_final_self, defaults.pe_thres_final_others],
    ]
    cthres = np.zeros((N_CTYPE, max_lmax + 1, cmax, N_THRES, N_ETYPE), dtype=np.int16)
    for t in range(N_CTYPE):
        for l in range(1, int(lmax[t]) + 1):
            p = pe[t, l]
            lpe = math.log(p)
            l1mpe = math.log(1 - p)
            for cout in range(1, cmax):
                # init: SELF slot = cout, OTHERS slot = 0 (wall.c:201-207)
                ct = [cout, 0]
                found = [[False, False], [False, False]]
                for s in range(N_THRES):
                    for e in range(N_ETYPE):
                        cthres[t, l, cout, s, e] = ct[e]
                psum = 1.0
                for cin in range(0, cout + 1):
                    if all(found[s][e] for s in range(2) for e in range(2)):
                        break
                    ct = [cin, cout - cin]
                    psum -= math.exp(logp_binom_pre(cin, cout, lpe, l1mpe))
                    for s in range(N_THRES):
                        for e in range(N_ETYPE):
                            if not found[s][e] and psum < pe_thres[s][e]:
                                cthres[t, l, cout, s, e] = ct[e]
                                found[s][e] = True
    return ErrorModel(lmax=lmax, pe=pe, cthres=cthres, cmax=cmax,
                      hc_erate=float(pe[Ctype.HP, 1]))


@dataclasses.dataclass
class GlobalModel:
    """Everything shared read-only by the per-read classifier."""

    kmer: int
    cov: np.ndarray        # (N_STATE,) = [1, R-thres, H, D] (ClassPro.c:544-547)
    dr_ratio: float        # 1 + N_SIGMA_R / sqrt(D) (ClassPro.c:548)
    emodel: ErrorModel
    read_len: int
    defaults: Defaults

    @property
    def cmax(self) -> int:
        return int(self.cov[State.REPEAT])


def build_global_model(hist: Histogram, defaults: Defaults | None = None,
                       coverage: int = 0, read_len: int | None = None,
                       model_path: str | None = None) -> GlobalModel:
    """Full global precomputation (ClassPro.c:536-554)."""
    defaults = defaults or Defaults()
    hcov, dcov = estimate_coverage(hist, coverage)
    cov = np.zeros(4, dtype=np.int64)
    cov[State.ERROR] = 1
    cov[State.HAPLO] = hcov
    cov[State.DIPLO] = dcov
    cov[State.REPEAT] = plus_sigma(dcov, defaults.n_sigma_rcov)
    if cov[State.REPEAT] > 255:
        raise ValueError(f"Too high REPEAT coverage ({cov[State.REPEAT]}) > 255")
    dr_ratio = 1.0 + defaults.n_sigma_r * (1.0 / math.sqrt(dcov))
    emodel = build_error_model(int(cov[State.REPEAT]), defaults, model_path)
    return GlobalModel(kmer=hist.kmer, cov=cov, dr_ratio=dr_ratio,
                       emodel=emodel,
                       read_len=read_len or defaults.read_len,
                       defaults=defaults)
