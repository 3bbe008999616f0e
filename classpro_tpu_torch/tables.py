"""Binomial-tail and threshold tables for the C++ host stages.

All binomial-tail tests in the wall stage have small integer arguments
(`cout < R-cov <= 255`), so they are precomputed once per dataset on the
host with exact C semantics (same loop order/rounding as prob.c:76-112)
and become table reads in csrc/host/classpro_host.cpp's wall walk and
relaxation.  The tail table is built there too (``native.build_btg``,
one C++ call); ``btg_plain`` (``_btg_row`` per row) is its plain numpy
version, which only the tests and chip_smoke.py call.

Table inventory (per GlobalModel):
  btg[r, n, k]    one-sided binomial tail binom_test_g(k, n, erate_r)
                  for n < n_cap; erate index r enumerates the distinct
                  context error rates + HC rate + the unrel 0.1 rate
  cthres          count-change thresholds (wall.c:167-244), int16
  pe_idx[t, l]    context (t, l) -> erate index r
  logfact         32768-entry log-factorial table
"""

from __future__ import annotations

import dataclasses

import numpy as np

from classpro_tpu_torch.estimation import GlobalModel
from classpro_tpu_torch.native import build_btg
from classpro_tpu_torch.numerics import LOGFACT


@dataclasses.dataclass
class DeviceTables:
    """Host-side (numpy) table set."""

    erates: np.ndarray       # (R,) f64 distinct error rates
    lerates: np.ndarray      # (R,) log(erate)
    l1merates: np.ndarray    # (R,) log(1 - erate)
    btg: np.ndarray          # (R, n_cap, n_cap) f64 tail probabilities
    pe_idx: np.ndarray       # (3, lmax+1) int32 -> erate index
    pe: np.ndarray           # (3, lmax+1) f64 error rates by context
    hc_idx: int              # erate index of the HC rate
    unrel_idx: int           # erate index of 0.1 (class_unrel.c:133)
    cthres: np.ndarray       # (3, lmax+1, cmax, 2, 2) int16
    logfact: np.ndarray      # (32768,) f64
    n_cap: int

    def btg_log(self) -> np.ndarray:
        """log of the tail table (log(0) = -inf), host-exact glibc log of
        the exact double — identical to the reference's runtime
        log(p_errorin(...)) values."""
        with np.errstate(divide="ignore"):
            return np.log(self.btg)


def _btg_row(n: int, erate: float) -> np.ndarray:
    """binom_test_g(k, n, erate, exact=False) for all k in [0, n],
    replicating the C loop order and early exit term-for-term
    (prob.c:76-112) but vectorized over k: the plain version of one row
    of ``native.build_btg``'s table.

    Terms use math.exp (libm) for bit-parity with the scalar path; the
    per-k partial sums replay the sequential addition order via a masked
    row-cumsum (np.cumsum is sequential per row)."""
    import math

    lpe = math.log(erate)
    l1mpe = math.log(1 - erate)
    lf = LOGFACT
    ks = np.arange(n + 1)
    logp = lf[n] - lf[ks] - lf[n - ks] + ks * lpe + (n - ks) * l1mpe
    terms = np.array([math.exp(v) for v in logp])
    mean = n * erate
    out = np.empty(n + 1, dtype=np.float64)

    dec = ks.astype(np.float64) >= mean
    # --- decrease branch: p = term[k] + term[k+1] + ... until early exit
    kd = ks[dec]
    if kd.size:
        # stop_x[k] = first x > k with 10*term[x] < term[k] (term added
        # before the break), else n
        T = terms[None, :]  # (1, n+1)
        cond = (10.0 * T < terms[kd, None]) & (ks[None, :] > kd[:, None])
        has = cond.any(axis=1)
        stop = np.where(has, np.argmax(cond, axis=1), n)
        mask = (ks[None, :] >= kd[:, None]) & (ks[None, :] <= stop[:, None])
        rows = np.where(mask, T, 0.0)
        csum = np.cumsum(rows, axis=1)
        out[kd] = csum[np.arange(kd.size), stop]
    # --- increase branch: p = term[k-1] + term[k-2] + ... (desc), 1 - p
    ki = ks[~dec]
    if ki.size:
        first = np.where(ki == 0, 0.0, terms[np.maximum(ki - 1, 0)])
        Tr = terms[None, ::-1]  # reversed so cumsum runs descending x
        xs_rev = ks[::-1][None, :]
        cond = (10.0 * Tr < first[:, None]) & (xs_rev < (ki - 1)[:, None])
        has = cond.any(axis=1)
        stop_rev = np.where(has, np.argmax(cond, axis=1), n)  # index in rev
        stop_x = n - stop_rev  # actual x of last added term
        # k == 0: loop body never runs (p stays 0)
        mask = (xs_rev <= (ki - 2)[:, None]) & (xs_rev >= stop_x[:, None]) \
            & (ki[:, None] > 0)
        rows = np.where(mask, np.broadcast_to(Tr, mask.shape), 0.0)
        # prepend `first` so the sequential addition order matches C:
        # ((first + t_{k-2}) + t_{k-3}) + ...
        rows_full = np.concatenate([first[:, None], rows], axis=1)
        csum = np.cumsum(rows_full, axis=1)
        p = np.where(ki > 0, csum[np.arange(ki.size), stop_rev + 1], 0.0)
        out[ki] = 1 - p
    return out


def btg_plain(erates, n_cap: int) -> np.ndarray:
    """The plain version of ``native.build_btg``'s table: one ``_btg_row``
    per (rate, n), zeros elsewhere (seconds of numpy for a model; the
    tests and chip_smoke.py hold the C++ table to it)."""
    out = np.zeros((len(erates), n_cap, n_cap), np.float64)
    for r, erate in enumerate(erates):
        for n in range(1, n_cap):
            out[r, n, :n + 1] = _btg_row(n, float(erate))
    return out


_CONTENT_CACHE: dict = {}


def build_tables(gm: GlobalModel, n_cap: int | None = None) -> DeviceTables:
    em = gm.emodel
    n_cap = n_cap or max(2 * gm.cmax + 2, 300)
    cached = getattr(gm, "_device_tables", None)
    if cached is not None and cached.n_cap == n_cap:
        return cached
    # content-keyed process cache: every engine/CLI call builds a fresh
    # GlobalModel for the same dataset, and identical models must not
    # build the tables twice
    import hashlib

    key = (gm.kmer, tuple(int(c) for c in gm.cov), float(gm.dr_ratio),
           int(gm.read_len), n_cap,
           hashlib.sha1(np.ascontiguousarray(em.pe).tobytes()).hexdigest(),
           hashlib.sha1(np.ascontiguousarray(em.cthres).tobytes()).hexdigest())
    hit = _CONTENT_CACHE.get(key)
    if hit is not None:
        try:
            object.__setattr__(gm, "_device_tables", hit)
        except Exception:
            pass
        return hit

    rates: list[float] = []

    def rate_id(r: float) -> int:
        for i, x in enumerate(rates):
            if x == r:
                return i
        rates.append(r)
        return len(rates) - 1

    pe_idx = np.zeros_like(em.pe, dtype=np.int32)
    for t in range(3):
        for l in range(1, int(em.lmax[t]) + 1):
            pe_idx[t, l] = rate_id(float(em.pe[t, l]))
    pe_idx[:, 0] = rate_id(float(em.pe[0, 1]))  # l=0 never queried; safe value
    hc_idx = rate_id(float(em.hc_erate))
    unrel_idx = rate_id(0.1)

    btg = build_btg(rates, n_cap, LOGFACT)
    dt = DeviceTables(
        erates=np.asarray(rates), lerates=np.log(rates),
        l1merates=np.log1p(np.negative(rates)),
        btg=btg, pe_idx=pe_idx, pe=em.pe.copy(), hc_idx=hc_idx,
        unrel_idx=unrel_idx, cthres=em.cthres.copy(),
        logfact=LOGFACT.copy(), n_cap=n_cap)
    try:
        object.__setattr__(gm, "_device_tables", dt)
    except Exception:
        pass
    _CONTENT_CACHE[key] = dt
    return dt
