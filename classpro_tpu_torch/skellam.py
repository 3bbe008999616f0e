"""log-Skellam via host-built interpolation tables.

The DP evaluates logp_skellam(k, lam) = -2*lam + log I_|k|(2*lam) at
arbitrary real lam (util.c:35), so no exact tabulation exists.  Two smooth
tables of log I_n(x) are built from the *C-replica* Bessel (table nodes
carry the reference's own ~1e-7 approximation error) and interpolated
with 4-point cubics:

* region A, x in [0, 64], uniform grid:   h(n,x) = log I_n(x) - n*log(x/2)
                                          + logfact[n]   (smooth, h(n,0)=0)
* region B, x in (64, X_MAX], uniform in sqrt(x):  g(n,x) = log I_n(x) - x

The host build (numpy) is a copy of the JAX package's builder; the table
is cached on disk under ``classpro_tpu_torch/_build/``.  The lookup
(``skellam_args`` / ``skellam_value``) is plain torch with the same
operation order as csrc/rel_dp_row.cuh's ``rd_skellam`` — the CUDA
kernel's inlined copy — so both give IEEE-identical results.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from classpro_tpu_torch.numerics import LOGFACT, bessi0 as _bessi0_scalar

NMAX = 384
XA_MAX = 64.0
NA_GRID = 2048
XB_MAX = 16384.0
NB_GRID = 4096
# C's bessi overflow / underflow cutoffs (bessel.c:399,520)
OVERFLOW = 709.782712893384
UNDERFLOW = -745.13

_BIGNO = 1.0e10
_BIGNI = 1.0e-10

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def _bessi_grid(xs: np.ndarray, nmax: int) -> np.ndarray:
    """I_n(x) for all n in [0, nmax] x grid xs, shape (nmax+1, len(xs)).

    Runs the per-order downward recurrence (bessel.c:478-520) for every
    (n, x) pair simultaneously: each matrix column/row keeps independent
    state, activated at its own start index jstart(n) — identical
    arithmetic to the scalar C loop."""
    from classpro_tpu_torch.numerics import bessi1 as _b1

    xs = np.asarray(xs, np.float64)
    G = xs.size
    ns = np.arange(2, nmax + 1)
    jstart = (2 * (ns + np.floor(np.sqrt(40.0 * ns)))).astype(np.int64)[:, None]
    jmax = int(jstart.max())
    tox = 2.0 / np.maximum(np.abs(xs), 1e-300)[None, :]
    bi = np.ones((ns.size, G))
    bip = np.zeros((ns.size, G))
    ans = np.zeros((ns.size, G))
    nsc = ns[:, None]
    for j in range(jmax, 0, -1):
        active = j <= jstart
        bim = bip + (j * tox) * bi
        np.copyto(bip, bi, where=active)
        np.copyto(bi, bim, where=active)
        over = active & (np.abs(bi) > _BIGNO)
        scale = np.where(over, _BIGNI, 1.0)
        ans *= scale
        bi *= scale
        bip *= scale
        np.copyto(ans, bip, where=active & (j == nsc))
    i0 = np.array([_bessi0_scalar(float(x)) for x in xs])
    out = np.empty((nmax + 1, G))
    out[0] = i0
    out[1] = np.array([_b1(float(x)) for x in xs])
    out[2:] = ans * (i0[None, :] / bi)
    out[2:, xs == 0.0] = 0.0
    return out


@dataclasses.dataclass
class SkellamTables:
    table_a: np.ndarray  # (NMAX+1, NA_GRID) h(n, x)
    table_b: np.ndarray  # (NMAX+1, NB_GRID) g(n, x), grid uniform in sqrt(x)
    logfact: np.ndarray


_CACHE: dict[int, SkellamTables] = {}


def _cache_path(nmax: int) -> str:
    os.makedirs(_BUILD, exist_ok=True)
    return os.path.join(_BUILD, f"skellam_n{nmax}_a{NA_GRID}_b{NB_GRID}.npz")


def build_skellam_tables(nmax: int = NMAX) -> SkellamTables:
    """The two tables, built once (~40 s of numpy) and cached on disk;
    concurrent processes wait on a lock instead of building twice."""
    import fcntl

    if nmax in _CACHE:
        return _CACHE[nmax]
    path = _cache_path(nmax)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            z = np.load(path)
            t = SkellamTables(z["ta"], z["tb"], LOGFACT.copy())
        else:
            t = _build_tables(nmax)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, ta=t.table_a, tb=t.table_b)
            os.replace(tmp, path)
    _CACHE[nmax] = t
    return t


def _build_tables(nmax: int) -> SkellamTables:
    ns = np.arange(nmax + 1)[:, None]
    lf = LOGFACT[: nmax + 1][:, None]

    xa = np.linspace(0.0, XA_MAX, NA_GRID)
    iva = _bessi_grid(xa, nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        ha = np.log(iva) - ns * np.log(np.maximum(xa, 1e-300)[None, :] / 2.0) + lf
    # underflowed I (or x=0) -> series first term is exact: h -> 0
    ta = np.where(np.isfinite(ha), ha, 0.0)
    ta[:, xa == 0.0] = 0.0

    ub = np.linspace(math.sqrt(XA_MAX), math.sqrt(XB_MAX), NB_GRID)
    xb = ub * ub
    ivb = _bessi_grid(xb, nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        gb = np.log(ivb) - xb[None, :]
    # the C replica overflows to inf for huge x (as the reference itself
    # would); fill those nodes with scipy's scaled Bessel so interpolation
    # stays smooth — the reference's value there is +inf either way.
    bad = ~np.isfinite(gb)
    if bad.any():
        import scipy.special as sp

        full = np.log(sp.ive(np.arange(nmax + 1)[:, None], xb[None, :]))
        gb = np.where(bad, full, gb)
    return SkellamTables(ta, gb, LOGFACT.copy())


_PACKED_CACHE: dict[int, "tuple"] = {}


def build_packed_skellam(nmax: int = NMAX):
    """Packed layout: one (NMAX+1, NA_GRID+NB_GRID, 5) f64 array whose
    [n, i] entry holds the 4 Lagrange nodes around grid index i plus
    logfact[n], so one evaluation reads one contiguous 40-byte record.
    Returns (packed table, logfact[:nmax+1])."""
    if nmax in _PACKED_CACHE:
        return _PACKED_CACHE[nmax]
    st = build_skellam_tables(nmax)

    def pack(tab: np.ndarray) -> np.ndarray:
        npts = tab.shape[1]
        idx = np.arange(npts)
        i1 = np.clip(idx, 1, npts - 3)
        cols = np.stack([i1 - 1, i1, i1 + 1, i1 + 2], axis=-1)  # (npts, 4)
        return tab[:, cols]                                     # (n, npts, 4)

    packed = np.concatenate([pack(st.table_a), pack(st.table_b)], axis=1)
    lf_col = np.broadcast_to(
        st.logfact[: nmax + 1][:, None, None],
        (nmax + 1, packed.shape[1], 1))
    packed = np.concatenate([packed, lf_col], axis=2)
    out = (packed, st.logfact[: nmax + 1].copy())
    _PACKED_CACHE[nmax] = out
    return out


# ---------------------------------------------------------------------
# Plain torch lookup (the yardstick of the kernel's rd_skellam).


def _two_prod(a, b):
    """Dekker two-product: a*b = hi + lo exactly (no FMA needed)."""
    hi = a * b
    c = 134217729.0                 # 2^27 + 1 (Veltkamp split)
    a1 = a * c
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = b * c
    bh = b1 - (b1 - b)
    bl = b - bh
    lo = ((ah * bh - hi) + ah * bl + al * bh) + al * bl
    return hi, lo


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f64 sqrt on every device.  torch's vectorised
    CPU sqrt (SLEEF, 0.5001 ulp) is one ulp off for ~0.7% of inputs;
    CUDA's double sqrt, the kernel's and numpy's are IEEE.  Of the
    candidates r-1ulp, r, r+1ulp the one with the smallest exact residual
    |x - c*c| is the correctly rounded root (no double x lies in the
    band where that rule and round-to-nearest disagree)."""
    r = torch.sqrt(x)

    def resid(c):
        hi, lo = _two_prod(c, c)
        return ((x - hi) - lo).abs()

    best, best_e = r, resid(r)
    for c in (torch.nextafter(r, torch.zeros_like(r)),
              torch.nextafter(r, torch.full_like(r, math.inf))):
        e = resid(c)
        take = e < best_e
        best = torch.where(take, c, best)
        best_e = torch.where(take, e, best_e)
    return best


def div_ieee(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` for a Python float ``s``, rounded as IEEE division on
    every device: torch's CUDA division by a Python scalar multiplies by
    the scalar's reciprocal instead, which can round differently (the
    kernel and the JAX package divide)."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def skellam_args(k: torch.Tensor, lam: torch.Tensor):
    """(n, idx, f, in_a, x, k_abs) for a packed-table evaluation
    (skellam_dev.skellam_args: k wraps to int32, then |k|)."""
    k = k.to(torch.int32).abs()
    lam = lam.to(torch.float64)
    x = torch.clamp(2.0 * lam, 0.0, XB_MAX)
    n = torch.clamp(k, 0, NMAX)

    pos_a = x * ((NA_GRID - 1) / XA_MAX)
    i1a = torch.clamp(torch.floor(pos_a).to(torch.int32), 1, NA_GRID - 3)
    fa = pos_a - i1a.to(torch.float64)
    u = sqrt_rn(x)
    du = (math.sqrt(XB_MAX) - math.sqrt(XA_MAX)) / (NB_GRID - 1)
    pos_b = div_ieee(u - math.sqrt(XA_MAX), du)
    i1b = torch.clamp(torch.floor(pos_b).to(torch.int32), 1, NB_GRID - 3)
    fb = pos_b - i1b.to(torch.float64)

    in_a = x <= XA_MAX
    idx = torch.where(in_a, i1a, NA_GRID + i1b)
    f = torch.where(in_a, fa, fb)
    return n, idx, f, in_a, x, k


def _interp4(nodes, f):
    """4-point Lagrange combination at offset f of nodes -1, 0, 1, 2."""
    w0 = div_ieee(-f * (f - 1.0) * (f - 2.0), 6.0)
    w1 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0
    w2 = -(f + 1.0) * f * (f - 2.0) / 2.0
    w3 = div_ieee((f + 1.0) * f * (f - 1.0), 6.0)
    return (w0 * nodes[..., 0] + w1 * nodes[..., 1]
            + w2 * nodes[..., 2] + w3 * nodes[..., 3])


def skellam_value(nodes, n, f, in_a, x, k, lam):
    """Assemble the log-Skellam value from gathered ``nodes`` (..., 5):
    4 Lagrange nodes + logfact[n] (skellam_dev.skellam_value)."""
    val = _interp4(nodes, f)
    lf_n = nodes[..., 4]
    log_xh = torch.where(x > 0, torch.log(x / 2.0),
                         torch.full_like(x, -math.inf))
    val_a = val + n.to(torch.float64) * log_xh - lf_n
    val_a = torch.where((x == 0.0) & (n == 0), torch.zeros_like(val_a),
                        val_a)
    val_b = val + x
    out = torch.where(in_a, val_a, val_b)
    out = torch.where((x >= OVERFLOW) | (out > OVERFLOW),
                      torch.full_like(out, math.inf), out)
    out = torch.where(out < UNDERFLOW, torch.full_like(out, -math.inf), out)
    out = -2.0 * lam.to(torch.float64) + out
    return torch.where(k > NMAX, torch.full_like(out, -math.inf), out)


def logp_skellam(k, lam, tab):
    """log Skellam from the packed table ``tab`` (385, 6144, 5)."""
    n, idx, f, in_a, x, ka = skellam_args(k, lam)
    nodes = tab[n.long(), idx.long()]
    return skellam_value(nodes, n, f, in_a, x, ka, lam)
