"""Plain torch reliable-interval DP (the yardstick of csrc/rel_dp.cu).

A line-by-line counterpart of the JAX package's ``rel_dev2.rel_dp_pass2``
with ``lanes=1``: ``_lane_init`` (class_rel.c:544-595), ``_lane_step``
(class_rel.c:279-513) driven for max(m)-1 steps, and the traceback
(class_rel.c:606-613).  Rows are vectorised; the steps are a Python loop,
so on the card this launches a few hundred small kernels per step — it
is the plain version the CUDA kernel is held against (CPU tests,
chip_smoke.py), never the main path on a card.

Semantics carried over unchanged (see rel_dev2.py for the derivations):
NaN-propagating size-4 maxima with strict-``>`` first-wins indices, the
C special cases on raw scores (has_inf poisoning, psum == 0, the
-745.13 exp-underflow cut), the init softmax kill, the H<D<R gate, the
per-cell path registers, and the exactness-guard margin (every argmax's
flip distance; 1e-30 force-flags).  ``_div_cr`` becomes plain ``/``,
IEEE in torch and in CUDA; float -> int64 casts saturate like XLA's
(NaN -> 0), and are taken only where their branch is.
"""

from __future__ import annotations

import math

import torch

from classpro_tpu_torch.params import RelParams
from classpro_tpu_torch.skellam import div_ieee, skellam_args, skellam_value

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4
NEG_INF = -math.inf
INF = math.inf
LOG_QUARTER = math.log(0.25)

# regs_i slot layout (int64, (B, 4 cells, 16))
_SP = 0          # 0:4   st_pos per slot (E,R,H,D)
_SC = 4          # 4:8   st_cnt per slot
_LH = 8          # 8:10  lastH (pos, cnt)
_LD = 10         # 10:12 lastD
_LHBD = 12       # 12:14 lastHbD
_LDBH = 14       # 14:16 lastDbH
# regs_b flag layout (bool, (B, 4 cells, 6))
_EXH, _EXD, _EXHBD, _EXDBH, _HASH, _HASD = range(6)

_I64_MAX = 2 ** 63 - 1
_I64_MIN = -2 ** 63


def sat_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 toward zero, saturating, NaN -> 0 (XLA's
    conversion semantics; a bare .to(int64) is undefined out of range)."""
    nan = torch.isnan(x)
    big = x >= 9223372036854775808.0
    small = x < -9223372036854775808.0
    safe = torch.where(nan | big | small, torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(big, torch.full_like(out, _I64_MAX), out)
    return torch.where(small, torch.full_like(out, _I64_MIN), out)


def _s4(x, dim):
    return x.unbind(dim)


def _emax4(x, dim):
    a, b, c, d = _s4(x, dim)
    return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))


def _emin4(x, dim):
    a, b, c, d = _s4(x, dim)
    return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))


def _emaxarg4(x, dim):
    """(max, first-wins argmax) along a size-4 dim; the max propagates
    NaN, the index moves only on a strict ``>``."""
    a, b, c, d = _s4(x, dim)
    v = a
    i = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for k, xk in ((1, b), (2, c), (3, d)):
        take = xk > v
        v = torch.maximum(v, xk)
        i = torch.where(take, torch.full_like(i, k), i)
    return v, i


def _eany4(x, dim):
    a, b, c, d = _s4(x, dim)
    return (a | b) | (c | d)


def _eall4(x, dim):
    a, b, c, d = _s4(x, dim)
    return (a & b) & (c & d)


def _full(like, v):
    return torch.full_like(like, v)


def _top2_margin(x, dim):
    """top1 - top2 along a size-4 dim; +inf when fewer than two finite
    candidates, 1e-30 when NaN-poisoned."""
    xs = _s4(x, dim)
    top1, am = _emaxarg4(x, dim)
    masked = [torch.where(am == k, _full(xk, NEG_INF), xk)
              for k, xk in enumerate(xs)]
    top2 = torch.maximum(torch.maximum(masked[0], masked[1]),
                         torch.maximum(masked[2], masked[3]))
    mgn = top1 - top2
    mgn = torch.where(torch.isneginf(top2), _full(mgn, INF), mgn)
    return torch.where(torch.isnan(mgn), _full(mgn, 1e-30), mgn)


def _sel4(reg, sel):
    """reg[b, sel[b, t], ...] for sel (B, 4)."""
    idx = sel.reshape(sel.shape + (1,) * (reg.ndim - 2)).expand(
        (reg.shape[0], 4) + reg.shape[2:])
    return torch.gather(reg, 1, idx)


def _lane_init(L, P: RelParams):
    """Initial DP cell (class_rel.c:544-595)."""
    B = L["bpos"].shape[0]
    dev = L["bpos"].device
    cov, fwd = L["cov"], L["fwd"]
    OFF, covR, covH = L["OFF"], L["covR"], L["covH"]
    covHf = cov[:, HAPLO].to(torch.float64)
    covDf = cov[:, DIPLO].to(torch.float64)

    pos_init = torch.where(fwd, torch.full_like(L["plen"], -P.offset),
                           L["plen"] + P.offset)
    bcnt0 = L["bcnt"][:, 0]
    ecnt0 = L["ecnt"][:, 0]
    epos0 = L["epos"][:, 0]
    lf_b0 = L["lf_bcnt"][:, 0]

    regs_i = torch.zeros((B, 4, 16), dtype=torch.int64, device=dev)
    regs_i[:, :, _SP:_SP + 4] = pos_init[:, None, None]
    regs_i[:, :, _SC:_SC + 4] = cov[:, None, :]

    dpE = L["logpE"][:, 0]

    st_r_cnt = covR
    n1 = P.lf_small.shape[0]
    lf_r = P.lf_small[torch.clamp(st_r_cnt, 0, n1 - 1)]
    lf_rd = P.lf_small[torch.clamp(st_r_cnt - bcnt0, 0, n1 - 1)]
    logp_er = torch.where(
        bcnt0 < st_r_cnt,
        lf_r - lf_b0 - lf_rd + bcnt0.to(torch.float64) * P.log_1m_pe_mean
        + (st_r_cnt - bcnt0).to(torch.float64) * P.log_pe_mean,
        _full(lf_r, NEG_INF))
    max_cc0 = L["max_cc"][:, 0]
    dpR = torch.where(
        logp_er > P.r_logp, logp_er,
        torch.where((max_cc0 >= cov[:, REPEAT]) | (max_cc0 >= st_r_cnt),
                    _full(logp_er, P.r_logp), logp_er))
    regs_i[:, REPEAT, _SP + REPEAT] = epos0
    regs_i[:, REPEAT, _SC + REPEAT] = torch.minimum(ecnt0, covR)

    dpH = bcnt0.to(torch.float64) * torch.log(covHf) - covHf - lf_b0
    regs_i[:, HAPLO, _SP + HAPLO] = epos0
    regs_i[:, HAPLO, _SC + HAPLO] = ecnt0
    regs_i[:, HAPLO, _SP + DIPLO] = epos0 - OFF
    regs_i[:, HAPLO, _SC + DIPLO] = ecnt0 + covH

    dpD = bcnt0.to(torch.float64) * torch.log(covDf) - covDf - lf_b0
    regs_i[:, DIPLO, _SP + HAPLO] = epos0 - OFF
    regs_i[:, DIPLO, _SC + HAPLO] = torch.maximum(
        torch.div(ecnt0, 2, rounding_mode="floor"), ecnt0 - covH)
    regs_i[:, DIPLO, _SP + DIPLO] = epos0
    regs_i[:, DIPLO, _SC + DIPLO] = ecnt0

    e2 = torch.stack([epos0, ecnt0], dim=1)                      # (B, 2)
    regs_i[:, HAPLO, _LH:_LH + 2] = e2
    regs_i[:, DIPLO, _LD:_LD + 2] = e2

    regs_b = torch.zeros((B, 4, 6), dtype=torch.bool, device=dev)
    regs_b[:, HAPLO, _EXH] = True
    regs_b[:, DIPLO, _EXD] = True
    regs_b[:, HAPLO, _HASH] = True
    regs_b[:, DIPLO, _HASD] = True

    dp0 = torch.stack([dpE, dpR, dpH, dpD], dim=1)

    # init normalisation: a state whose softmax probability underflows
    # to exactly 0.0 is dead (the kill is discrete; fuzz seed 21517)
    p0 = torch.exp(dp0)
    psum0 = ((p0[:, 0] + p0[:, 1]) + p0[:, 2]) + p0[:, 3]
    v0 = p0 / psum0[:, None]
    dp0 = torch.where(v0 > 0.0, dp0, _full(dp0, NEG_INF))
    # guard: flag rows within a whisker of the kill line, and the
    # degenerate all-dead / overflow cases
    t0 = dp0 - torch.log(psum0)[:, None]
    near = _eany4(torch.abs(t0 + 745.1332) < 0.1, 1)
    degen = (psum0 == 0.0) | ~torch.isfinite(psum0)
    mm0 = torch.where(near | degen, _full(psum0, 1e-30), _full(psum0, INF))

    dh0 = torch.full((B, 4), NEG_INF, dtype=torch.float64, device=dev)
    return (dp0, dh0, regs_i, regs_b, e2, mm0)


def _lane_step(carry, xs, consts, P: RelParams):
    """One DP step (class_rel.c:279-513)."""
    dp, dh, regs_i, regs_b, eff, mmin = carry
    bpos_i, bcnt_i, epos_i, ecnt_i, max_cc_i, lf_b_i, logpE_i, i = xs
    cov, fwd = consts["cov"], consts["fwd"]
    OFF, PSTEP = consts["OFF"], consts["PSTEP"]
    covR, covH, m = consts["covR"], consts["covH"], consts["m"]
    B = dp.shape[0]
    dev = dp.device
    iota4 = torch.arange(4, device=dev)[None, :]
    f64 = torch.float64

    st_pos = regs_i[:, :, _SP:_SP + 4]
    st_cnt = regs_i[:, :, _SC:_SC + 4]

    logpE = logpE_i[:, None].expand(B, 4)

    # R target emission (class_rel.c:172-211) from the carried count
    strc = st_cnt[:, :, REPEAT]                              # (B, 4)
    n1 = P.lf_small.shape[0]
    lf_strc = P.lf_small[torch.clamp(strc, 0, n1 - 1)]
    lf_sd = P.lf_small[torch.clamp(strc - bcnt_i[:, None], 0, n1 - 1)]
    bc = bcnt_i[:, None]
    logp_er_r = torch.where(
        bc < strc,
        lf_strc - lf_b_i[:, None] - lf_sd + bc.to(f64) * P.log_1m_pe_mean
        + (strc - bc).to(f64) * P.log_pe_mean, _full(lf_strc, NEG_INF))
    logpR = torch.where(
        logp_er_r > P.r_logp, logp_er_r,
        torch.where((max_cc_i[:, None] >= cov[:, REPEAT][:, None])
                    | (max_cc_i[:, None] >= strc),
                    _full(logp_er_r, P.r_logp), logp_er_r))

    # H/D targets: Skellam transitions
    sth_p = st_pos[:, :, HAPLO]
    sth_c = st_cnt[:, :, HAPLO]
    std_p = st_pos[:, :, DIPLO]
    std_c = st_cnt[:, :, DIPLO]
    use_ratio = dh != NEG_INF
    h_cb = torch.where(use_ratio, std_c, sth_c)
    h_pos = torch.where(use_ratio, std_p, sth_p)
    h_ce = torch.where(use_ratio, sat_i64(dh * bc.to(f64)), bc.expand(B, 4))
    kH = h_ce - h_cb
    lamH = div_ieee(
        h_cb.to(f64)
        * torch.abs(bpos_i[:, None] - (h_pos - PSTEP[:, None])).to(f64),
        P.read_len)
    kD = bc - std_c
    lamD = div_ieee(
        std_c.to(f64)
        * torch.abs(bpos_i[:, None] - (std_p - PSTEP[:, None])).to(f64),
        P.read_len)
    k_all = torch.stack([kH, kD], dim=1)                     # (B, 2, 4)
    lam_all = torch.stack([lamH, lamD], dim=1)
    n_, idx_, f_, in_a, x_, ka = skellam_args(k_all, lam_all)
    if "gathers" in consts:
        # the table records this step needs: live rows, live source cells
        need = (i < m)[:, None, None] & (dp != NEG_INF)[:, None, :]
        consts["gathers"].append(
            (n_.long() * P.tab.shape[1] + idx_.long())[need.expand_as(n_)])
    nodes = P.tab[n_.long(), idx_.long()]
    lp_hd = skellam_value(nodes, n_, f_, in_a, x_, ka, lam_all)
    logpH, logpD = lp_hd[:, 0, :], lp_hd[:, 1, :]

    logp_st = torch.stack([logpE, logpR, logpH, logpD], dim=2)
    # normalisation dropped (argmax-invariant); C special cases kept
    lp = torch.where((dp == NEG_INF)[:, :, None], _full(logp_st, NEG_INF),
                     logp_st)
    mx = _emax4(_emax4(lp, 2), 1)
    has_inf = torch.isposinf(mx)
    zero = mx < -745.13  # C: psum == 0.0 (all exp underflow)
    logp_tr = torch.where(
        has_inf[:, None, None],
        torch.where(torch.isposinf(lp), _full(lp, math.nan),
                    _full(lp, NEG_INF)), lp)
    quarter = torch.where(iota4[:, None, :] == ERROR,
                          _full(lp, LOG_QUARTER), _full(lp, NEG_INF))
    logp_tr = torch.where(zero[:, None, None], quarter, logp_tr)

    # exp-underflow cut (class_rel.c:321-336) and the denormal band flag
    m_band = torch.where(
        _eany4(_eany4((logp_tr > -745.2) & (logp_tr < -719.0), 2), 1),
        _full(mx, 1e-30), _full(mx, INF))
    logp_tr = torch.where(logp_tr < -745.13, _full(logp_tr, NEG_INF),
                          logp_tr)

    # ---- only_r (class_rel.c:348-356)
    scores = dp[:, :, None] + logp_tr
    sc_best_t, best_t = _emaxarg4(scores, 2)
    dead_s = sc_best_t == NEG_INF
    only_r = _eall4(dead_s | (best_t == REPEAT), 1)
    sc_rep = scores[:, :, REPEAT]
    sc_oth = _emax4(torch.where(iota4[:, None, :] == REPEAT,
                                _full(scores, NEG_INF), scores), 2)
    m_or = torch.abs(sc_rep - sc_oth)
    m_or = torch.where(torch.isneginf(sc_rep) | torch.isneginf(sc_oth),
                       _full(m_or, INF), m_or)
    m_or = torch.where(torch.isnan(m_or), _full(m_or, 1e-30), m_or)
    rep_s = dead_s | (best_t == REPEAT)
    p1 = rep_s[:, 0]
    p2 = p1 & rep_s[:, 1]
    prefix_ok = torch.stack(
        [torch.ones_like(p1), p1, p2, p2 & rep_s[:, 2]], dim=1)
    m_onlyr = _emin4(torch.where(prefix_ok, m_or, _full(m_or, INF)), 1)

    # ---- HH/DD coupling (class_rel.c:383-386)
    colH = scores[:, :, HAPLO]
    colD = scores[:, :, DIPLO]
    vH, aH = _emaxarg4(colH, 1)
    vD, aD = _emaxarg4(colD, 1)
    maxs_h = torch.where(vH == NEG_INF, _full(aH, N_STATE), aH)
    maxs_d = torch.where(vD == NEG_INF, _full(aD, N_STATE), aD)
    couple = (maxs_h == HAPLO) & (maxs_d == DIPLO)

    def _bin_margin(col, idx):
        own = col[:, idx]
        oth = _emax4(torch.where(iota4 == idx, _full(col, NEG_INF), col), 1)
        d = torch.abs(own - oth)
        d = torch.where(torch.isneginf(own) | torch.isneginf(oth),
                        _full(d, INF), d)
        return torch.where(torch.isnan(d), _full(d, 1e-30), d)

    m_coup = torch.minimum(_bin_margin(colH, HAPLO),
                           _bin_margin(colD, DIPLO))
    mcoup = torch.minimum(logp_tr[:, HAPLO, HAPLO], logp_tr[:, DIPLO, DIPLO])
    logp_tr = logp_tr.clone()
    logp_tr[:, HAPLO, HAPLO] = torch.where(couple, mcoup,
                                           logp_tr[:, HAPLO, HAPLO])
    logp_tr[:, DIPLO, DIPLO] = torch.where(couple, mcoup,
                                           logp_tr[:, DIPLO, DIPLO])
    scores = dp[:, :, None] + logp_tr

    # ---- per-target best predecessor (class_rel.c:390-397)
    max_v, max_s = _emaxarg4(scores, 1)     # (B, t); ties -> E<R<H<D
    dead_t = max_v == NEG_INF
    sel = torch.where(dead_t, torch.zeros_like(max_s), max_s)
    m_sel = _emin4(_top2_margin(scores, 1), 1)

    regs_i_n = _sel4(regs_i, sel)
    regs_b_n = _sel4(regs_b, sel)
    st_pos_n = regs_i_n[:, :, _SP:_SP + 4]
    st_cnt_n = regs_i_n[:, :, _SC:_SC + 4]
    lastH_n = regs_i_n[:, :, _LH:_LH + 2]
    lastD_n = regs_i_n[:, :, _LD:_LD + 2]
    lastHbD_n = regs_i_n[:, :, _LHBD:_LHBD + 2]
    lastDbH_n = regs_i_n[:, :, _LDBH:_LDBH + 2]
    exH_n = regs_b_n[:, :, _EXH]
    exD_n = regs_b_n[:, :, _EXD]
    exHbD_n = regs_b_n[:, :, _EXHBD]
    exDbH_n = regs_b_n[:, :, _EXDBH]
    hasH_n = regs_b_n[:, :, _HASH]
    hasD_n = regs_b_n[:, :, _HASD]

    oe = epos_i - OFF                                        # (B,)

    # REPEAT target st (class_rel.c:413-425)
    rp = st_pos_n[:, REPEAT, :]
    rc = st_cnt_n[:, REPEAT, :]
    r_cnt = torch.minimum(ecnt_i, covR)
    keep_r = rc[:, REPEAT] < r_cnt
    newR_pos = rp.clone()
    newR_pos[:, HAPLO] = oe
    newR_pos[:, DIPLO] = oe
    newR_pos[:, REPEAT] = torch.where(keep_r, rp[:, REPEAT], oe)
    newR_cnt = rc.clone()
    newR_cnt[:, REPEAT] = torch.where(keep_r, rc[:, REPEAT], r_cnt)

    # dh ratio from registers (calc_dh_ratio, class_rel.c:113-156)
    def dh_ratio_of(init_s: int):
        if init_s == HAPLO:
            o2, oe2 = lastD_n[:, HAPLO, :], exD_n[:, HAPLO]
            o3, oe3 = lastHbD_n[:, HAPLO, :], exHbD_n[:, HAPLO]
        else:
            o2, oe2 = lastH_n[:, DIPLO, :], exH_n[:, DIPLO]
            o3, oe3 = lastDbH_n[:, DIPLO, :], exDbH_n[:, DIPLO]
        ok = oe2 & oe3
        s1p, s1c = bpos_i, bcnt_i
        tp, tc = o2[:, 0], o2[:, 1]
        s2p, s2c = o3[:, 0], o3[:, 1]
        # class_rel.c:134-138: the backward pass swaps s1 and s2
        s1p_, s1c_ = torch.where(fwd, s1p, s2p), torch.where(fwd, s1c, s2c)
        s2p_, s2c_ = torch.where(fwd, s2p, s1p), torch.where(fwd, s2c, s1c)
        est = (s2c_.to(f64)
               + ((s1c_ - s2c_) * (tp - s2p_)).to(f64)
               / (s1p_ - s2p_).to(f64))
        tcf = tc.to(f64)
        r = est / tcf if init_s == DIPLO else tcf / est
        return torch.where(ok, r, _full(r, NEG_INF))

    rH = dh_ratio_of(HAPLO)
    rD = dh_ratio_of(DIPLO)

    # HAPLO target (class_rel.c:426-459)
    curr_h_H = ecnt_i
    curr_d_H = torch.where(
        rH != NEG_INF, sat_i64(rH * curr_h_H.to(f64)),
        torch.where(hasD_n[:, HAPLO], st_cnt_n[:, HAPLO, DIPLO],
                    curr_h_H + covH))
    curr_r_H = sat_i64(P.dr_ratio * curr_d_H.to(f64))

    # DIPLO target (class_rel.c:460-493)
    curr_d_D = ecnt_i
    curr_h_D = torch.where(
        rD != NEG_INF, sat_i64(curr_d_D.to(f64) / rD),
        torch.where(hasH_n[:, DIPLO], st_cnt_n[:, DIPLO, HAPLO],
                    torch.maximum(torch.div(curr_d_D, 2,
                                            rounding_mode="floor"),
                                  curr_d_D - covH)))
    curr_r_D = sat_i64(P.dr_ratio * curr_d_D.to(f64))

    new_st_pos = torch.stack([
        st_pos_n[:, ERROR, :], newR_pos,
        torch.stack([st_pos_n[:, HAPLO, ERROR], oe, oe, oe], dim=1),
        torch.stack([st_pos_n[:, DIPLO, ERROR], oe, oe, oe], dim=1)], dim=1)
    new_st_cnt = torch.stack([
        st_cnt_n[:, ERROR, :], newR_cnt,
        torch.stack([st_cnt_n[:, HAPLO, ERROR], curr_r_H, curr_h_H,
                     curr_d_H], dim=1),
        torch.stack([st_cnt_n[:, DIPLO, ERROR], curr_r_D, curr_h_D,
                     curr_d_D], dim=1)], dim=1)

    ninf = torch.full((B,), NEG_INF, dtype=f64, device=dev)
    new_dh = torch.stack([ninf, ninf, rH, rD], dim=1)

    gate = ((new_st_cnt[:, :, HAPLO] < new_st_cnt[:, :, DIPLO])
            & (new_st_cnt[:, :, DIPLO] < new_st_cnt[:, :, REPEAT]))
    new_dp = torch.where(dead_t | ~gate, _full(max_v, NEG_INF), max_v)

    # path registers: extend with target t
    cur2 = torch.stack([epos_i, ecnt_i], dim=1)[:, None, :].expand(B, 4, 2)
    isH = (iota4 == HAPLO).expand(B, 4)
    isD = (iota4 == DIPLO).expand(B, 4)
    new_regs_i = torch.cat([
        new_st_pos, new_st_cnt,
        torch.where(isH[:, :, None], cur2, lastH_n),
        torch.where(isD[:, :, None], cur2, lastD_n),
        torch.where(isD[:, :, None], lastH_n, lastHbD_n),
        torch.where(isH[:, :, None], lastD_n, lastDbH_n)], dim=2)
    new_regs_b = torch.stack([
        exH_n | isH, exD_n | isD,
        torch.where(isD, exH_n, exHbD_n),
        torch.where(isH, exD_n, exDbH_n),
        hasH_n | isH, hasD_n | isD], dim=2)

    # ---- only_r overrides (class_rel.c:357-380): same-state copy
    alive = dp != NEG_INF
    eff2 = eff[:, None, :].expand(B, 4, 2)
    oH = isH & alive
    oD = isD & alive
    o_regs_i = torch.cat([
        regs_i[:, :, _SP:_SC + 4],
        torch.where(oH[:, :, None], eff2, regs_i[:, :, _LH:_LH + 2]),
        torch.where(oD[:, :, None], eff2, regs_i[:, :, _LD:_LD + 2]),
        torch.where(oD[:, :, None], regs_i[:, :, _LH:_LH + 2],
                    regs_i[:, :, _LHBD:_LHBD + 2]),
        torch.where(oH[:, :, None], regs_i[:, :, _LD:_LD + 2],
                    regs_i[:, :, _LDBH:_LDBH + 2])], dim=2)
    o_regs_b = torch.stack([
        regs_b[:, :, _EXH] | oH, regs_b[:, :, _EXD] | oD,
        torch.where(oD, regs_b[:, :, _EXH], regs_b[:, :, _EXHBD]),
        torch.where(oH, regs_b[:, :, _EXD], regs_b[:, :, _EXDBH]),
        regs_b[:, :, _HASH] | oH, regs_b[:, :, _HASD] | oD], dim=2)

    live = i < m

    def pick(upd, onr, old):
        shape = (B,) + (1,) * (upd.ndim - 1)
        return torch.where(live.reshape(shape),
                           torch.where(only_r.reshape(shape), onr, upd), old)

    # guard: the only_r margin always counts; the selection/coupling
    # margins only when the step selects; has_inf rows always flag
    m_poison = torch.where(has_inf, _full(mx, 1e-30), _full(mx, INF))
    step_margin = torch.minimum(
        torch.minimum(m_onlyr, torch.minimum(m_band, m_poison)),
        torch.where(only_r, _full(m_coup, INF),
                    torch.minimum(m_coup, m_sel)))
    mmin_n = torch.where(live, torch.minimum(mmin, step_margin), mmin)

    carry_n = (
        pick(new_dp, dp, dp),
        pick(new_dh, _full(dh, NEG_INF), dh),
        pick(new_regs_i, o_regs_i, regs_i),
        pick(new_regs_b, o_regs_b, regs_b),
        pick(torch.stack([epos_i, ecnt_i], dim=1), eff, eff),
        mmin_n,
    )
    bp = torch.where(live[:, None],
                     torch.where(only_r[:, None], iota4.expand(B, 4),
                                 torch.where(dead_t, _full(max_s, N_STATE),
                                             max_s)),
                     _full(max_s, N_STATE)).to(torch.int8)
    return carry_n, (bp, live & only_r)


def rel_dp_ref(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen,
               fwd, cov, P: RelParams, gathers: list | None = None):
    """One merged-direction DP pass over (B, max_m) planes in scan order
    (backward rows index-reversed by the caller).  int64 planes ``bpos``
    ``bcnt`` ``epos`` ``ecnt`` ``max_cc``; f64 ``lf_bcnt`` (logfact of
    bcnt) and ``logpE`` (the E emission); ``m``/``plen`` int64 (B,);
    ``fwd`` bool (B,); ``cov`` int64 (B, 4).  ``gathers``, if given,
    receives per step the flat indices of the Skellam-table records the
    live steps read (chip_smoke.py counts the distinct ones for the
    kernel's byte bound).

    Returns (asgn int8 (B, max_m), final dp f64 (B, 4), min decision
    margin f64 (B,))."""
    B, max_m = bpos.shape
    dev = bpos.device
    fwd = fwd.to(torch.bool)
    L = {
        "bpos": bpos, "bcnt": bcnt, "epos": epos, "ecnt": ecnt,
        "max_cc": max_cc, "lf_bcnt": lf_bcnt, "logpE": logpE,
        "m": m, "plen": plen, "fwd": fwd, "cov": cov,
        "OFF": torch.where(fwd, P.offset, -P.offset).to(torch.int64),
        "PSTEP": torch.where(fwd, 1, -1).to(torch.int64),
        "covR": cov[:, REPEAT], "covH": cov[:, HAPLO],
    }
    carry = _lane_init(L, P)
    consts = {k: L[k] for k in ("cov", "fwd", "OFF", "PSTEP", "covR",
                                "covH", "m")}
    if gathers is not None:
        consts["gathers"] = gathers
    # rows beyond their own m are no-ops through the in-step live mask,
    # so max(m)-1 steps are exactly the padded max_m-1
    trip = max(int(m.max()) - 1, 0) if B else 0
    bps = torch.full((max_m - 1, B, 4), N_STATE, dtype=torch.int8,
                     device=dev)
    rpos = torch.zeros((B, max_m), dtype=torch.bool, device=dev)
    for t in range(trip):
        j = t + 1
        xs = (bpos[:, j], bcnt[:, j], epos[:, j], ecnt[:, j], max_cc[:, j],
              lf_bcnt[:, j], logpE[:, j], j)
        carry, (bp, rp) = _lane_step(carry, xs, consts, P)
        bps[t] = bp
        rpos[:, j] = rp
    dp_f, mmin = carry[0], carry[5]

    # ---------------- traceback (class_rel.c:606-613) ------------------
    # min FIRST, then the all-dead force flag: an exact-tie step margin
    # of 0.0 must not mask it (the C traceback reads an uninitialised
    # row for an all-dead final cell, so such rows go to the host)
    mm = torch.minimum(mmin, _top2_margin(dp_f, 1))
    all_dead = _eall4(dp_f == NEG_INF, 1)
    mm = torch.where(all_dead, _full(mm, 1e-30), mm)

    last = torch.clamp(m - 1, min=0)
    cur = _emaxarg4(dp_f, 1)[1]
    asgn = cur[:, None].expand(B, max_m).clone()
    tb_trip = int(last.max()) if B else 0
    for j in range(tb_trip, 0, -1):
        asgn[:, j] = torch.where(j <= last, cur, asgn[:, j])
        prev = torch.gather(bps[j - 1].to(torch.int64), 1,
                            torch.clamp(cur, 0, 3)[:, None])[:, 0]
        cur = torch.where(j <= last, prev, cur)
    asgn[:, 0] = cur
    asgn = torch.where(rpos, torch.full_like(asgn, REPEAT), asgn)
    return asgn.to(torch.int8), dp_f, mm
