"""Probability kernels with bit-exact C-double semantics.

Mirrors the reference's numeric core (prob.c, bessel.c, util.c) operation
by operation: the classifier's decisions are argmaxes and threshold
comparisons over these values, so byte-identical ``.class`` output requires
bit-identical float64 results.  Every function here has a scalar form
(used by the exact oracle engine) and, where hot, a NumPy-vectorized form;
the device forms are ``skellam`` (torch) and csrc/rel_dp_row.cuh (CUDA).

Reference lines are cited per function.
"""

from __future__ import annotations

import math

import numpy as np

from classpro_tpu_torch.constants import MAX_KMER_CNT

# ---------------------------------------------------------------------------
# log-factorial table (prob.c:12-19): sequential accumulation, same rounding
# ---------------------------------------------------------------------------

LOGFACT = np.zeros(MAX_KMER_CNT + 1, dtype=np.float64)
LOGFACT[1:] = np.cumsum(np.log(np.arange(1, MAX_KMER_CNT + 1, dtype=np.float64)))


def _check_cnt(n: int) -> int:
    """DEBUG clamp active in the reference release build (prob.c:22-31)."""
    return MAX_KMER_CNT if n > MAX_KMER_CNT else n


# ---------------------------------------------------------------------------
# Modified Bessel I_n (bessel.c:390-520, Numerical-Recipes polynomials)
# ---------------------------------------------------------------------------

_ACC = 40.0
_BIGNO = 1.0e10
_BIGNI = 1.0e-10


def c_exp(x: float) -> float:
    """C exp() semantics: overflow returns +inf instead of raising."""
    try:
        return math.exp(x)
    except OverflowError:
        return float("inf")


def bessi0(x: float) -> float:
    ax = abs(x)
    if ax < 3.75:
        y = x / 3.75
        y = y * y
        return 1.0 + y * (3.5156229 + y * (3.0899424 + y * (1.2067492
               + y * (0.2659732 + y * (0.360768e-1 + y * 0.45813e-2)))))
    y = 3.75 / ax
    return (c_exp(ax) / math.sqrt(ax)) * (0.39894228 + y * (0.1328592e-1
           + y * (0.225319e-2 + y * (-0.157565e-2 + y * (0.916281e-2
           + y * (-0.2057706e-1 + y * (0.2635537e-1 + y * (-0.1647633e-1
           + y * 0.392377e-2))))))))


def bessi1(x: float) -> float:
    ax = abs(x)
    if ax < 3.75:
        y = x / 3.75
        y = y * y
        ans = ax * (0.5 + y * (0.87890594 + y * (0.51498869 + y * (0.15084934
              + y * (0.2658733e-1 + y * (0.301532e-2 + y * 0.32411e-3))))))
    else:
        y = 3.75 / ax
        ans = 0.2282967e-1 + y * (-0.2895312e-1 + y * (0.1787654e-1
              - y * 0.420059e-2))
        ans = 0.39894228 + y * (-0.3988024e-1 + y * (-0.362018e-2
              + y * (0.163801e-2 + y * (-0.1031555e-1 + y * ans))))
        ans *= c_exp(ax) / math.sqrt(ax)
    return -ans if x < 0.0 else ans


def bessi(n: int, x: float) -> float:
    """I_n(x) by downward recurrence (bessel.c:478-520)."""
    if n < 0:
        raise ValueError("n < 0 in bessi")
    if n == 0:
        return bessi0(x)
    if n == 1:
        return bessi1(x)
    if x == 0.0:
        return 0.0
    tox = 2.0 / abs(x)
    bip = ans = 0.0
    bi = 1.0
    for j in range(2 * (n + int(math.sqrt(_ACC * n))), 0, -1):
        bim = bip + j * tox * bi
        bip = bi
        bi = bim
        if abs(bi) > _BIGNO:
            ans *= _BIGNI
            bi *= _BIGNI
            bip *= _BIGNI
        if j == n:
            ans = bip
    ans *= bessi0(x) / bi
    return -ans if (x < 0.0 and n % 2 == 1) else ans


# ---------------------------------------------------------------------------
# Bessel J_n / Y_n / K_n (bessel.c:22-388, 526-647).  Dead code in the
# reference — only bessi is on any ClassPro path (prob.c:41 logp_skellam) —
# ported for component completeness with the same NR polynomials, recurrence
# order, and error semantics (ValueError where the C fprintf+exit(1)s).
# Golden-tested against the compiled reference harness
# (tests/fixtures/bessel_golden.txt, tests/test_numerics.py).
# ---------------------------------------------------------------------------


def _bessj0(x: float) -> float:
    """bessel.c:80 (static bessj0)."""
    ax = abs(x)
    if ax < 8.0:
        y = x * x
        ans1 = 57568490574.0 + y * (-13362590354.0 + y * (651619640.7
               + y * (-11214424.18 + y * (77392.33017 + y * (-184.9052456)))))
        ans2 = 57568490411.0 + y * (1029532985.0 + y * (9494680.718
               + y * (59272.64853 + y * (267.8532712 + y * 1.0))))
        return ans1 / ans2
    z = 8.0 / ax
    y = z * z
    xx = ax - 0.785398164
    ans1 = 1.0 + y * (-0.1098628627e-2 + y * (0.2734510407e-4
           + y * (-0.2073370639e-5 + y * 0.2093887211e-6)))
    ans2 = -0.1562499995e-1 + y * (0.1430488765e-3
           + y * (-0.6911147651e-5 + y * (0.7621095161e-6
           - y * 0.934935152e-7)))
    return math.sqrt(0.636619772 / ax) * (math.cos(xx) * ans1
                                          - z * math.sin(xx) * ans2)


def _bessj1(x: float) -> float:
    """bessel.c:115 (static bessj1)."""
    ax = abs(x)
    if ax < 8.0:
        y = x * x
        ans1 = x * (72362614232.0 + y * (-7895059235.0 + y * (242396853.1
               + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606))))))
        ans2 = 144725228442.0 + y * (2300535178.0 + y * (18583304.74
               + y * (99447.43394 + y * (376.9991397 + y * 1.0))))
        return ans1 / ans2
    z = 8.0 / ax
    y = z * z
    xx = ax - 2.356194491
    ans1 = 1.0 + y * (0.183105e-2 + y * (-0.3516396496e-4
           + y * (0.2457520174e-5 + y * (-0.240337019e-6))))
    ans2 = 0.04687499995 + y * (-0.2002690873e-3
           + y * (0.8449199096e-5 + y * (-0.88228987e-6
           + y * 0.105787412e-6)))
    ans = math.sqrt(0.636619772 / ax) * (math.cos(xx) * ans1
                                         - z * math.sin(xx) * ans2)
    return -ans if x < 0.0 else ans


def bessj(n: int, x: float) -> float:
    """J_n(x) (bessel.c:184-245): upward recurrence for ax > n, downward
    Miller's algorithm with BIGNO renormalization otherwise."""
    if n < 0:
        raise ValueError("n<0 @ bessj")
    ax = abs(x)
    if n == 0:
        return _bessj0(ax)
    if n == 1:
        return _bessj1(ax)
    if ax == 0.0:
        return 0.0
    if ax > float(n):
        tox = 2.0 / ax
        bjm = _bessj0(ax)
        bj = _bessj1(ax)
        for j in range(1, n):
            bjp = j * tox * bj - bjm
            bjm = bj
            bj = bjp
        ans = bj
    else:
        tox = 2.0 / ax
        m = 2 * ((n + int(math.sqrt(_ACC * n))) // 2)
        jsum = 0
        bjp = ans = s = 0.0
        bj = 1.0
        for j in range(m, 0, -1):
            bjm = j * tox * bj - bjp
            bjp = bj
            bj = bjm
            if abs(bj) > _BIGNO:
                bj *= _BIGNI
                bjp *= _BIGNI
                ans *= _BIGNI
                s *= _BIGNI
            if jsum:
                s += bj
            jsum = not jsum
            if j == n:
                ans = bjp
        s = 2.0 * s - bj
        ans /= s
    return -ans if (x < 0.0 and n % 2 == 1) else ans


def _bessy0(x: float) -> float:
    """bessel.c:248 (static bessy0); note the deliberate 0.934945152e-7
    coefficient (bessy0 differs from bessj0's 0.934935152e-7 in the C)."""
    if x < 8.0:
        y = x * x
        ans1 = -2957821389.0 + y * (7062834065.0 + y * (-512359803.6
               + y * (10879881.29 + y * (-86327.92757 + y * 228.4622733))))
        ans2 = 40076544269.0 + y * (745249964.8 + y * (7189466.438
               + y * (47447.26470 + y * (226.1030244 + y * 1.0))))
        return (ans1 / ans2) + 0.636619772 * _bessj0(x) * math.log(x)
    z = 8.0 / x
    y = z * z
    xx = x - 0.785398164
    ans1 = 1.0 + y * (-0.1098628627e-2 + y * (0.2734510407e-4
           + y * (-0.2073370639e-5 + y * 0.2093887211e-6)))
    ans2 = -0.1562499995e-1 + y * (0.1430488765e-3
           + y * (-0.6911147651e-5 + y * (0.7621095161e-6
           + y * (-0.934945152e-7))))
    return math.sqrt(0.636619772 / x) * (math.sin(xx) * ans1
                                         + z * math.cos(xx) * ans2)


def _bessy1(x: float) -> float:
    """bessel.c:283 (static bessy1)."""
    if x < 8.0:
        y = x * x
        ans1 = x * (-0.4900604943e13 + y * (0.1275274390e13
               + y * (-0.5153438139e11 + y * (0.7349264551e9
               + y * (-0.4237922726e7 + y * 0.8511937935e4)))))
        ans2 = 0.2499580570e14 + y * (0.4244419664e12
               + y * (0.3733650367e10 + y * (0.2245904002e8
               + y * (0.1020426050e6 + y * (0.3549632885e3 + y)))))
        return (ans1 / ans2) + 0.636619772 * (_bessj1(x) * math.log(x)
                                              - 1.0 / x)
    z = 8.0 / x
    y = z * z
    xx = x - 2.356194491
    ans1 = 1.0 + y * (0.183105e-2 + y * (-0.3516396496e-4
           + y * (0.2457520174e-5 + y * (-0.240337019e-6))))
    ans2 = 0.04687499995 + y * (-0.2002690873e-3
           + y * (0.8449199096e-5 + y * (-0.88228987e-6
           + y * 0.105787412e-6)))
    return math.sqrt(0.636619772 / x) * (math.sin(xx) * ans1
                                         + z * math.cos(xx) * ans2)


def bessy(n: int, x: float) -> float:
    """Y_n(x) (bessel.c:349-384): upward recurrence from Y_0, Y_1."""
    if n < 0 or x == 0.0:
        raise ValueError("n<0||x=0.0 @ bessy")
    if n == 0:
        return _bessy0(x)
    if n == 1:
        return _bessy1(x)
    tox = 2.0 / x
    by = _bessy1(x)
    bym = _bessy0(x)
    for j in range(1, n):
        byp = j * tox * by - bym
        bym = by
        by = byp
    return by


def _bessk0(x: float) -> float:
    """bessel.c:526 (static bessk0)."""
    if x <= 2.0:
        y = x * x / 4.0
        return (-math.log(x / 2.0) * bessi0(x)) + (-0.57721566 + y * (0.42278420
               + y * (0.23069756 + y * (0.3488590e-1 + y * (0.262698e-2
               + y * (0.10750e-3 + y * 0.74e-5))))))
    y = 2.0 / x
    return (c_exp(-x) / math.sqrt(x)) * (1.25331414 + y * (-0.7832358e-1
           + y * (0.2189568e-1 + y * (-0.1062446e-1 + y * (0.587872e-2
           + y * (-0.251540e-2 + y * 0.53208e-3))))))


def _bessk1(x: float) -> float:
    """bessel.c:550 (static bessk1)."""
    if x <= 2.0:
        y = x * x / 4.0
        return (math.log(x / 2.0) * bessi1(x)) + (1.0 / x) * (1.0
               + y * (0.15443144 + y * (-0.67278579 + y * (-0.18156897
               + y * (-0.1919402e-1 + y * (-0.110404e-2
               + y * (-0.4686e-4)))))))
    y = 2.0 / x
    return (c_exp(-x) / math.sqrt(x)) * (1.25331414 + y * (0.23498619
           + y * (-0.3655620e-1 + y * (0.1504268e-1 + y * (-0.780353e-2
           + y * (0.325614e-2 + y * (-0.68245e-3)))))))


def bessk(n: int, x: float) -> float:
    """K_n(x) (bessel.c:610-647): upward recurrence from K_0, K_1."""
    if n < 0 or x == 0.0:
        raise ValueError("n<0||x=0.0 @ bessk")
    if n == 0:
        return _bessk0(x)
    if n == 1:
        return _bessk1(x)
    tox = 2.0 / x
    bkm = _bessk0(x)
    bk = _bessk1(x)
    for j in range(1, n):
        bkp = bkm + j * tox * bk
        bkm = bk
        bk = bkp
    return bk


# ---------------------------------------------------------------------------
# Log-probability kernels (prob.c:33-73)
# ---------------------------------------------------------------------------


def logp_poisson(k: int, lam: int) -> float:
    """prob.c:33 — k * log(lambda) - lambda - logfact[k]; k clamped."""
    k = _check_cnt(k)
    return k * math.log(float(lam)) - lam - LOGFACT[k]


def c_log(x: float) -> float:
    """C log() semantics: log(0) = -inf, log(<0) = NaN (no exception)."""
    if x > 0.0:
        return math.log(x)
    if x == 0.0:
        return float("-inf")
    return float("nan")


def logp_skellam(k: int, lam: float) -> float:
    """prob.c:41 — -2*lambda + log(I_|k|(2*lambda)).

    The Bessel term underflows to 0 for large |k| with small lambda —
    C's log maps that to -inf (a legitimate 'impossible transition')."""
    return -2.0 * lam + c_log(bessi(abs(k), 2.0 * lam))


def logp_binom(k: int, n: int, p: float) -> float:
    """prob.c:59."""
    k = _check_cnt(k)
    n = _check_cnt(n)
    return (LOGFACT[n] - LOGFACT[k] - LOGFACT[n - k]
            + k * math.log(p) + (n - k) * math.log(1 - p))


def logp_binom_pre(k: int, n: int, lpe: float, l1mpe: float) -> float:
    """prob.c:67."""
    return LOGFACT[n] - LOGFACT[k] - LOGFACT[n - k] + k * lpe + (n - k) * l1mpe


def binom_test_g(k: int, n: int, pe: float, exact: bool) -> float:
    """One-sided binomial tail test with early-exit approximation
    (prob.c:76-112).  Loop order and the `10*p_curr < p_first` exit are
    semantics, not optimizations — they determine the returned rounding."""
    k = _check_cnt(k)
    n = _check_cnt(n)
    lpe = math.log(pe)
    l1mpe = math.log(1 - pe)
    mean = n * pe
    if float(k) >= mean:
        p = p_first = math.exp(logp_binom_pre(k, n, lpe, l1mpe))
        for x in range(k + 1, n + 1):
            p_curr = math.exp(logp_binom_pre(x, n, lpe, l1mpe))
            p += p_curr
            if not exact and 10 * p_curr < p_first:
                break
        return p
    p = p_first = 0.0 if k == 0 else math.exp(logp_binom_pre(k - 1, n, lpe, l1mpe))
    for x in range(k - 2, -1, -1):
        p_curr = math.exp(logp_binom_pre(x, n, lpe, l1mpe))
        p += p_curr
        if not exact and 10 * p_curr < p_first:
            break
    return 1 - p


# ---------------------------------------------------------------------------
# Misc helpers (util.c)
# ---------------------------------------------------------------------------


def plus_sigma(cnt: int, n_sigma: int) -> int:
    """util.c:9 — cnt + trunc(sqrt(cnt) * n_sigma)."""
    return cnt + int(math.sqrt(cnt) * n_sigma)


def minus_sigma(cnt: int, n_sigma: int) -> int:
    """util.c:13."""
    return cnt - int(math.sqrt(cnt) * n_sigma)


def linear_interpolation(x: int, pos1: int, cnt1: int, pos2: int, cnt2: int) -> float:
    """util.c:24 — interpolate count at x between (pos1,cnt1), (pos2,cnt2)."""
    return float(cnt1) + (float(cnt2) - cnt1) * (x - pos1) / (pos2 - pos1)


def logp_trans(b: int, e: int, cb: int, ce: int, cov: int, read_len: int) -> float:
    """util.c:35 — Skellam count-drift transition model."""
    return logp_skellam(ce - cb, float(cov) * abs(e - b) / read_len)


def p_errorin(etype: int, erate: float, cout: int, cin: int) -> float:
    """util.c:46 — binomial test of cin errors-in-self (etype==SELF) or
    cout-cin errors-in-others."""
    return binom_test_g(cin if etype == 0 else cout - cin, cout, erate, False)
