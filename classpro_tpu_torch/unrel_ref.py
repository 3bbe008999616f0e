"""Plain torch relaxation sweeps (the yardstick of csrc/unrel.cu).

A step-for-step counterpart of the JAX package's
``unrel_dev2.unrel_sweeps2`` with ``lanes=1`` (``_unrel_lane.step_fn``,
class_unrel.c:248-300): the descending sweep, then the ascending one, each
step re-deciding one unreliable interval from its nearest reliable H/D
neighbours.  Rows are vectorised; the steps are a Python loop, so on the
card this launches a few hundred small kernels per step: it is what the
CUDA kernel is held against (CPU tests, chip_smoke.py), never the main
path on a card.

Semantics carried over unchanged: NaN-propagating maxima, the argmax over
[E, R, H, D] taking the first NaN (jnp.argmax) and otherwise the first
maximum, the exactness-guard margin (rel_ref._top2_margin, +inf where the
decision is forced to R or the step is inactive), the clamped log-factorial
index, float -> int64 casts that saturate like XLA's (NaN -> 0).  Where the
JAX code mixes int64 with a Python float (x64 gives float64) the port casts
to float64 first (torch would give float32); ``_div_cr`` becomes IEEE
``/``, and the division by ``read_len`` divides by a tensor (CUDA torch
multiplies by the reciprocal of a Python scalar).
"""

from __future__ import annotations

import math

import torch

from classpro_tpu_torch.params import UnrelParams
from classpro_tpu_torch.rel_ref import _emaxarg4, _top2_margin, sat_i64
from classpro_tpu_torch.skellam import div_ieee, logp_skellam, skellam_args

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4
NEG_INF = -math.inf
INF = math.inf

# plane order in the per-interval static value tensor P13
(CB, CE, LFCB, LFCE, XL, XR, LE,
 POHB, POHE, PODB, PODE, PEOB, PEOE) = range(13)


def argmax4(x: torch.Tensor) -> torch.Tensor:
    """jnp.argmax along a size-4 last dim: the first NaN if any, else the
    first maximum."""
    i = _emaxarg4(x, 1)[1]
    nan = torch.isnan(x)
    for k in (3, 2, 1, 0):
        i = torch.where(nan[:, k], torch.full_like(i, k), i)
    return i


def _take(plane: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """plane[b, j[b]] (plane (B, N) or (B, N, K)), 0 where j lies outside
    [0, N) (the JAX code's one-hot reads); floats gain +0.0, as a one-hot
    sum turns -0.0 into +0.0."""
    B, N = plane.shape[:2]
    ok = (j >= 0) & (j < N)
    jc = j.clamp(0, N - 1)
    idx = jc.reshape((B, 1) + (1,) * (plane.ndim - 2)).expand(
        (B, 1) + plane.shape[2:])
    g = torch.gather(plane, 1, idx)[:, 0]
    ok = ok.reshape((B,) + (1,) * (g.ndim - 1))
    g = torch.where(ok, g, torch.zeros_like(g))
    return g + 0.0 if g.is_floating_point() else g


def _step(a, idx, lv, C, P: UnrelParams):
    """One sweep step (unrel_dev2.py:157-279) on the working assignments
    ``a`` (int64 (B, N)): returns (a, step margin (B,))."""
    B, N = a.shape
    dev = a.device
    f64 = torch.float64
    cols = C["cols"]
    n = C["n"]
    is_rel = C["is_rel"]
    ninf = torch.full((B,), NEG_INF, dtype=f64, device=dev)

    nb = _take(a, idx - 1)
    cur = _take(a, idx)
    na = _take(a, idx + 1)
    v = _take(C["P13"], idx)                                   # (B, 13)
    icb = sat_i64(v[:, CB])
    ice = sat_i64(v[:, CE])
    x_l, x_r = v[:, XL], v[:, XR]
    lE = v[:, LE]

    # ---- nearest reliable H/D neighbours (class_unrel.c:11-25)
    S2 = torch.tensor([HAPLO, DIPLO], device=dev)[None, :, None]
    match = is_rel[:, None, :] & (a[:, None, :] == S2)          # (B, 2, N)
    in_l = match & (cols < idx[:, None])[:, None, :]
    lHD = torch.where(in_l, cols[:, None, :], -1).amax(2)
    in_r = match & (cols > idx[:, None])[:, None, :]
    rHD = torch.where(in_r, cols[:, None, :], N).amin(2)
    rHD = torch.where(rHD == N, -1, rHD)
    # slot order [H-left, H-right, D-left, D-right]
    J4 = torch.stack([lHD[:, 0], rHD[:, 0], lHD[:, 1], rHD[:, 1]], dim=1)
    packs = (C["packL"], C["packR"], C["packL"], C["packR"])
    V4 = torch.stack([_take(packs[j], J4[:, j]) for j in range(4)], dim=1)
    nn_ok = J4 != -1                                            # (B, 4)

    # ---- logp_r_u (class_unrel.c:67-113): uncorrected neighbour counts
    cov_d_f = torch.full((B,), float(P.cov_d), dtype=f64, device=dev)
    dl = torch.where(nn_ok[:, 2], V4[:, 2, 2],
                     torch.where(nn_ok[:, 3], V4[:, 3, 2], cov_d_f))
    dr = torch.where(nn_ok[:, 3], V4[:, 3, 2],
                     torch.where(nn_ok[:, 2], V4[:, 2, 2], cov_d_f))
    rlrr = sat_i64(P.dr_ratio * torch.stack([dl, dr], dim=1))  # (B, 2)
    k2 = torch.stack([icb, ice], dim=1)
    over = (k2 >= rlrr).any(1)
    lf2 = torch.stack([v[:, LFCB], v[:, LFCE]], dim=1)
    n1 = P.lf_small.shape[0]

    def lf(i):
        return P.lf_small[i.clamp(0, n1 - 1)]

    bi2 = (lf(rlrr) - lf2 - lf(rlrr - k2)
           + k2.to(f64) * P.log_1m_pe_mean
           + (rlrr - k2).to(f64) * P.log_pe_mean)
    lp_r = bi2[:, 0] + bi2[:, 1]
    hi = torch.maximum(icb, ice) >= P.cov_r
    lR = torch.where(hi, torch.zeros_like(lp_r),
                     torch.where(over, torch.full_like(lp_r, P.r_logp),
                                 lp_r))

    # ---- est_cov for (H,D) x (left,right) lanes (class_unrel.c:27-43)
    xq4 = torch.stack([x_l, x_r, x_l, x_r], dim=1)              # (B, 4)
    lj = torch.stack([lHD[:, 0], lHD[:, 0], lHD[:, 1], lHD[:, 1]], dim=1)
    rj = torch.stack([rHD[:, 0], rHD[:, 0], rHD[:, 1], rHD[:, 1]], dim=1)
    Lc = V4[:, [0, 0, 2, 2], 0]
    Le = V4[:, [0, 0, 2, 2], 1]
    Rc = V4[:, [1, 1, 3, 3], 0]
    Rb = V4[:, [1, 1, 3, 3], 1]
    l_ok, r_ok = lj != -1, rj != -1
    both = l_ok & r_ok
    interp = Lc + ((Rc - Lc) * (xq4 - Le)) / (Rb - Le)
    zero = torch.zeros_like(lj)
    val4 = torch.where(both, sat_i64(interp),
                       torch.where(l_ok, sat_i64(Lc),
                                   torch.where(r_ok, sat_i64(Rc), zero)))
    found4 = l_ok | r_ok
    # cross-state fallback: the other state's value on the same side
    val_o = torch.cat([val4[:, 2:], val4[:, :2]], dim=1)
    found_o = torch.cat([found4[:, 2:], found4[:, :2]], dim=1)
    lo2 = (torch.arange(4, device=dev) < 2)[None, :]
    cov_hd = torch.where(lo2, P.cov_h, P.cov_d).expand(B, 4)
    fb = torch.where(found_o & (val_o > 0),
                     torch.where(lo2, torch.div(val_o, 2,
                                                rounding_mode="floor"),
                                 val_o * 2), cov_hd)
    estf = torch.where(found4, val4, fb)

    # ---- Skellam drift to the neighbours
    cnt4 = torch.stack([icb, ice, icb, ice], dim=1)
    sign4 = torch.tensor([1, -1, 1, -1], device=dev)[None, :]
    kk = sign4 * (cnt4 - sat_i64(V4[:, :, 0]))
    lamm = div_ieee(V4[:, :, 0] * torch.abs(xq4 - V4[:, :, 1]), P.read_len)
    sk = logp_skellam(kk, lamm, P.tab)

    # ---- binomial tails at the estimated coverages
    nq = estf.clamp(1, P.n_cap - 1)
    kq = (estf - cnt4).clamp(0, P.n_cap - 1)
    tail_idx = (nq * P.n_cap + kq).to(torch.int32).long()
    tails = P.btg_flat[tail_idx]
    sfe = torch.where(estf >= cnt4, tails, torch.full_like(tails, NEG_INF))

    # ---- per-state side combination (class_unrel.c:115-183)
    S2f = S2[:, :, 0]                                           # (1, 2)
    er_l = torch.where(((idx - 1) >= 0)[:, None] & (nb[:, None] == S2f),
                       v[:, PEOB][:, None], ninf[:, None])
    er_r = torch.where(((idx + 1) < n)[:, None] & (na[:, None] == S2f),
                       v[:, PEOE][:, None], ninf[:, None])
    sf_l = torch.where(nn_ok[:, 0::2], sk[:, 0::2], ninf[:, None])
    sf_r = torch.where(nn_ok[:, 1::2], sk[:, 1::2], ninf[:, None])
    logp_l = torch.maximum(torch.maximum(er_l, sf_l), sfe[:, 0::2])
    logp_r = torch.maximum(torch.maximum(er_r, sf_r), sfe[:, 1::2])
    po_b = torch.stack([v[:, POHB], v[:, PODB]], dim=1)
    po_e = torch.stack([v[:, POHE], v[:, PODE]], dim=1)
    l_inf = logp_l == NEG_INF
    r_inf = logp_r == NEG_INF
    both_inf = l_inf & r_inf
    lp_l = torch.where(both_inf, po_b, torch.where(l_inf, logp_r, logp_l))
    lp_r2 = torch.where(both_inf, po_e, torch.where(r_inf, lp_l, logp_r))
    lHD_ = lp_l + lp_r2                                         # (B, 2)

    cand = torch.cat([lE[:, None], lR[:, None], lHD_], dim=1)
    smax = argmax4(cand)
    force_r = torch.maximum(icb, ice) >= P.cov_r
    new = torch.where(force_r, torch.full_like(smax, REPEAT), smax)

    active = lv & ~_take(C["is_fixed"], idx)
    if "gathers" in C:
        # the table records the active steps read (the kernel runs no other)
        n_, idx_ = skellam_args(kk, lamm)[:2]
        rec = n_.long() * P.tab.shape[1] + idx_.long()
        C["gathers"]["skellam"].append(rec[active])
        C["gathers"]["btg"].append(tail_idx[active])
    upd = torch.where(active, new, cur)
    a = torch.where((cols == idx[:, None]) & active[:, None], upd[:, None],
                    a)
    # exactness-guard margin; a forced REPEAT is an exact int compare
    m_step = _top2_margin(cand, 1)
    m_step = torch.where(force_r | ~active, torch.full_like(m_step, INF),
                         m_step)
    return a, m_step


def unrel_sweeps_ref(is_rel, asgn, P13, packL, packR, idx_desc, idx_asc,
                     live, n, P: UnrelParams, gathers: dict | None = None):
    """Both relaxation sweeps over a batch of reads (B rows, N interval
    slots).  ``is_rel`` bool (B, N); ``asgn`` int32 (B, N) in [0, 4]
    (4 = unclassified); ``P13`` f64 (B, N, 13); ``packL`` = (cce, e-1, ce)
    and ``packR`` = (ccb, b, cb) f64 (B, N, 3); ``idx_desc``/``idx_asc``
    int32 (B, N): the interval each step decides, in [0, N) on live steps;
    ``live`` bool (B, N): which steps run; ``n`` int32 (B,).
    ``gathers``, if given, receives under "skellam" and "btg" the flat
    indices of the Skellam-table records and binomial tails the active
    steps read (chip_smoke.py counts the distinct ones for the kernel's
    byte bound).

    Returns (asgn int8 (B, N), min decision margin f64 (B,))."""
    B, N = asgn.shape
    dev = asgn.device
    cols = torch.arange(N, device=dev)[None, :]
    n64 = n.to(torch.int64)
    is_rel = is_rel & (cols < n64[:, None])
    a = asgn.to(torch.int64)
    C = {"cols": cols, "n": n64, "is_rel": is_rel, "P13": P13,
         "packL": packL, "packR": packR,
         "is_fixed": is_rel & ((a == HAPLO) | (a == DIPLO))}
    if gathers is not None:
        gathers.update(skellam=[], btg=[])
        C["gathers"] = gathers
    mm = torch.full((B,), INF, dtype=torch.float64, device=dev)
    # steps with no live row are no-ops: run the others only
    steps = torch.nonzero(live.any(0)).flatten().tolist() if B else []
    for xs in (idx_desc, idx_asc):
        for t in steps:
            idx = xs[:, t].to(torch.int64)
            lv = live[:, t] & (idx >= 0) & (idx < N)
            a, m_step = _step(a, idx, lv, C, P)
            mm = torch.minimum(mm, m_step)
    return a.to(torch.int8), mm
