// Reliable-interval Viterbi DP for ONE row (one read, one scan direction):
// the init cell, the m-1 steps and the traceback.  Shared by the CUDA
// kernel (rel_dp.cu, nvcc) and the host test shim (the same file under
// g++ -x c++), so the CPU tests exercise the arithmetic the card runs.
//
// Replaces the JAX package's rel_dev2._lane_init (:224), _lane_step
// (:318) inside the while loop of rel_dp_pass2 (:636-720), the inlined
// skellam_dev.skellam_args/skellam_value lookup (:284-323) and the
// traceback (rel_dev2.py:723-785).  Semantics follow the JAX code line
// for line; classpro_tpu_torch/rel_ref.py is the plain torch version.
//
// Numerics (the build uses --fmad=false / -ffp-contract=off, never fast
// math): every expression keeps the reference's operation order; the
// size-4 maxima propagate NaN (fmax would drop it) with a strict-'>'
// first-wins index; float -> int64 casts saturate (NaN -> 0) like XLA's
// and are evaluated only on the branch that is taken; _div_cr is plain
// IEEE division.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RD_FN __host__ __device__ __forceinline__
#else
#define RD_FN static inline
#endif

#ifdef __CUDA_ARCH__
#define RD_LDG(p) __ldg(p)
#define RD_INF __longlong_as_double(0x7ff0000000000000LL)
#define RD_NAN __longlong_as_double(0x7ff8000000000000LL)
#else
#define RD_LDG(p) (*(p))
#define RD_INF ((double)INFINITY)
#define RD_NAN ((double)NAN)
#endif

namespace rd {

enum { ERR = 0, REP = 1, HAP = 2, DIP = 3, NST = 4 };
// path-register slots (rel_dev2.py regs_i / regs_b)
enum { SP = 0, SC = 4, LH = 8, LD = 10, LHBD = 12, LDBH = 14, NI = 16 };
enum { EXH = 0, EXD = 1, EXHBD = 2, EXDBH = 3, HASH = 4, HASD = 5, NB = 6 };

// Skellam table geometry (skellam.py)
constexpr int NMAX = 384;
constexpr double XA_MAX = 64.0;
constexpr int NA_GRID = 2048;
constexpr double XB_MAX = 16384.0;
constexpr int NB_GRID = 4096;
constexpr int NCOL = NA_GRID + NB_GRID;
constexpr double POS_A = (NA_GRID - 1) / XA_MAX;   // == Python's double
constexpr double DU = (128.0 - 8.0) / (NB_GRID - 1);  // (sqrt(XB)-sqrt(XA))/(NB-1)
constexpr double OVF = 709.782712893384;
constexpr double UNF = -745.13;
constexpr double LOG_QUARTER = -1.3862943611198906;  // log(0.25)

struct Params {
  const double* tab;       // (NMAX+1, NCOL, 5) packed Skellam table
  const double* lf_small;  // (n1,) logfact head
  int n1;
  double read_len;
  long long offset;
  double r_logp, log_1m_pe_mean, log_pe_mean, dr_ratio;
};

struct Args {
  // (R2, max_m) planes in scan order
  const long long *bpos, *bcnt, *epos, *ecnt, *max_cc;
  const double *lf_bcnt, *logpE;
  const long long *m, *plen;       // (R2,)
  const unsigned char* fwd;        // (R2,)
  const long long* cov;            // (R2, 4)
  const unsigned char* active;     // (R2,) or null (all rows)
  signed char* asgn;               // out (R2, max_m)
  double* dp_out;                  // out (R2, 4)
  double* mm_out;                  // out (R2,)
  signed char* bp;                 // scratch (R2, max_m-1, 4)
  unsigned char* rpos;             // scratch (R2, max_m)
  int R2, max_m;
  Params P;
};

RD_FN bool isnan_(double x) { return x != x; }
RD_FN bool isfinite_(double x) { return fabs(x) <= 1.7976931348623157e308; }

// jnp.maximum / jnp.minimum: NaN-propagating
RD_FN double max_(double a, double b) {
  return (isnan_(a) || isnan_(b)) ? RD_NAN : (a > b ? a : b);
}
RD_FN double min_(double a, double b) {
  return (isnan_(a) || isnan_(b)) ? RD_NAN : (a < b ? a : b);
}
RD_FN double max4(double a, double b, double c, double d) {
  return max_(max_(a, b), max_(c, d));
}
RD_FN double min4(double a, double b, double c, double d) {
  return min_(min_(a, b), min_(c, d));
}
// _emaxarg4: NaN-propagating max, first-wins index on strict '>'
RD_FN double maxarg4(const double x[4], int* idx) {
  double v = x[0];
  int i = 0;
  for (int k = 1; k < 4; ++k) {
    bool take = x[k] > v;
    v = max_(v, x[k]);
    if (take) i = k;
  }
  *idx = i;
  return v;
}
// _top2_margin
RD_FN double top2_margin(const double x[4]) {
  int am;
  double top1 = maxarg4(x, &am);
  double ms[4];
  for (int k = 0; k < 4; ++k) ms[k] = (am == k) ? -RD_INF : x[k];
  double top2 = max4(ms[0], ms[1], ms[2], ms[3]);
  double mgn = top1 - top2;
  if (top2 == -RD_INF) mgn = RD_INF;
  return isnan_(mgn) ? 1e-30 : mgn;
}

// XLA float -> int64: toward zero, saturating, NaN -> 0
RD_FN long long sat_i64(double x) {
  if (isnan_(x)) return 0;
  if (x >= 9223372036854775808.0) return 0x7fffffffffffffffLL;
  if (x < -9223372036854775808.0) return -0x7fffffffffffffffLL - 1;
  return (long long)x;
}
RD_FN long long floordiv2(long long a) { return (a - (a & 1)) / 2; }
RD_FN long long mini(long long a, long long b) { return a < b ? a : b; }
RD_FN long long maxi(long long a, long long b) { return a > b ? a : b; }
RD_FN long long clampi(long long a, long long lo, long long hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
// two's-complement wrap-around, as XLA's and torch's int64 arithmetic
RD_FN long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
RD_FN long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}
RD_FN long long wabs(long long a) {
  return a < 0 ? (long long)(0ULL - (unsigned long long)a) : a;
}

// log Skellam (skellam_dev.skellam_args + skellam_value): 4-point
// Lagrange over the packed table, C's overflow/underflow cutoffs
RD_FN double skellam(long long k64, double lam, const double* tab) {
  int kw = (int)(unsigned int)(unsigned long long)k64;   // int32 wrap
  int k = kw < 0 ? (int)(0u - (unsigned int)kw) : kw;    // jnp.abs
  double x = 2.0 * lam;
  x = x < 0.0 ? 0.0 : x;
  x = x > XB_MAX ? XB_MAX : x;
  int n = k < 0 ? 0 : (k > NMAX ? NMAX : k);

  double pos_a = x * POS_A;
  int i1a = (int)floor(pos_a);
  i1a = i1a < 1 ? 1 : (i1a > NA_GRID - 3 ? NA_GRID - 3 : i1a);
  double fa = pos_a - (double)i1a;
  double u = sqrt(x);
  double pos_b = (u - 8.0) / DU;
  int i1b = (int)floor(pos_b);
  i1b = i1b < 1 ? 1 : (i1b > NB_GRID - 3 ? NB_GRID - 3 : i1b);
  double fb = pos_b - (double)i1b;
  bool in_a = x <= XA_MAX;
  int idx = in_a ? i1a : NA_GRID + i1b;
  double f = in_a ? fa : fb;

  const double* nd = tab + ((long long)n * NCOL + idx) * 5;
  double y0 = RD_LDG(nd), y1 = RD_LDG(nd + 1), y2 = RD_LDG(nd + 2);
  double y3 = RD_LDG(nd + 3), lf_n = RD_LDG(nd + 4);
  double w0 = -f * (f - 1.0) * (f - 2.0) / 6.0;
  double w1 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0;
  double w2 = -(f + 1.0) * f * (f - 2.0) / 2.0;
  double w3 = (f + 1.0) * f * (f - 1.0) / 6.0;
  double val = w0 * y0 + w1 * y1 + w2 * y2 + w3 * y3;

  double log_xh = x > 0.0 ? log(x / 2.0) : -RD_INF;
  double val_a = val + (double)n * log_xh - lf_n;
  if (x == 0.0 && n == 0) val_a = 0.0;
  double val_b = val + x;
  double out = in_a ? val_a : val_b;
  if (x >= OVF || out > OVF) out = RD_INF;
  if (out < UNF) out = -RD_INF;
  out = -2.0 * lam + out;
  return k > NMAX ? -RD_INF : out;
}

struct State {
  double dp[4], dh[4];
  long long ri[4][NI];
  bool rb[4][NB];
  long long eff[2];
  double mmin;
};

struct RowConst {
  long long cov[4];
  bool fwd;
  long long OFF, PSTEP, covR, covH;
};

// _lane_init (class_rel.c:544-595)
RD_FN void init_cell(State& S, const RowConst& C, long long plen,
                     long long bcnt0, long long ecnt0, long long epos0,
                     long long max_cc0, double lf_b0, double logpE0,
                     const Params& P) {
  const double covHf = (double)C.cov[HAP], covDf = (double)C.cov[DIP];
  const long long pos_init = C.fwd ? -P.offset : plen + P.offset;
  for (int c = 0; c < 4; ++c) {
    for (int k = 0; k < NI; ++k) S.ri[c][k] = 0;
    for (int k = 0; k < NB; ++k) S.rb[c][k] = false;
    for (int k = 0; k < 4; ++k) {
      S.ri[c][SP + k] = pos_init;
      S.ri[c][SC + k] = C.cov[k];
    }
  }
  const long long covR = C.covR;
  double lf_r = RD_LDG(P.lf_small + clampi(covR, 0, P.n1 - 1));
  double lf_rd = RD_LDG(P.lf_small + clampi(covR - bcnt0, 0, P.n1 - 1));
  double logp_er = bcnt0 < covR
      ? lf_r - lf_b0 - lf_rd + (double)bcnt0 * P.log_1m_pe_mean
            + (double)(covR - bcnt0) * P.log_pe_mean
      : -RD_INF;
  double dpR = logp_er > P.r_logp
      ? logp_er
      : ((max_cc0 >= C.cov[REP] || max_cc0 >= covR) ? P.r_logp : logp_er);
  S.ri[REP][SP + REP] = epos0;
  S.ri[REP][SC + REP] = mini(ecnt0, covR);

  double dpH = (double)bcnt0 * log(covHf) - covHf - lf_b0;
  S.ri[HAP][SP + HAP] = epos0;
  S.ri[HAP][SC + HAP] = ecnt0;
  S.ri[HAP][SP + DIP] = epos0 - C.OFF;
  S.ri[HAP][SC + DIP] = ecnt0 + C.covH;

  double dpD = (double)bcnt0 * log(covDf) - covDf - lf_b0;
  S.ri[DIP][SP + HAP] = epos0 - C.OFF;
  S.ri[DIP][SC + HAP] = maxi(floordiv2(ecnt0), ecnt0 - C.covH);
  S.ri[DIP][SP + DIP] = epos0;
  S.ri[DIP][SC + DIP] = ecnt0;

  S.ri[HAP][LH] = epos0;
  S.ri[HAP][LH + 1] = ecnt0;
  S.ri[DIP][LD] = epos0;
  S.ri[DIP][LD + 1] = ecnt0;
  S.rb[HAP][EXH] = true;
  S.rb[DIP][EXD] = true;
  S.rb[HAP][HASH] = true;
  S.rb[DIP][HASD] = true;

  double dp0[4] = {logpE0, dpR, dpH, dpD};
  // init normalisation: a state whose softmax probability underflows to
  // exactly 0.0 is dead (discrete kill, fuzz seed 21517)
  double p0[4];
  for (int s = 0; s < 4; ++s) p0[s] = exp(dp0[s]);
  double psum = ((p0[0] + p0[1]) + p0[2]) + p0[3];
  bool near = false;
  double lps = log(psum);
  for (int s = 0; s < 4; ++s) {
    double v0 = p0[s] / psum;
    if (!(v0 > 0.0)) dp0[s] = -RD_INF;     // nan/0 -> dead, like C
    double t0 = dp0[s] - lps;
    if (fabs(t0 + 745.1332) < 0.1) near = true;
  }
  bool degen = (psum == 0.0) || !isfinite_(psum);
  S.mmin = (near || degen) ? 1e-30 : RD_INF;
  for (int s = 0; s < 4; ++s) {
    S.dp[s] = dp0[s];
    S.dh[s] = -RD_INF;
  }
  S.eff[0] = epos0;
  S.eff[1] = ecnt0;
}

// binary margin of row idx topping column col (the coupling trigger)
RD_FN double bin_margin(const double col[4], int idx) {
  double own = col[idx];
  double o[4];
  for (int c = 0; c < 4; ++c) o[c] = (c == idx) ? -RD_INF : col[c];
  double oth = max4(o[0], o[1], o[2], o[3]);
  double d = fabs(own - oth);
  if (own == -RD_INF || oth == -RD_INF) d = RD_INF;
  return isnan_(d) ? 1e-30 : d;
}

// calc_dh_ratio (class_rel.c:113-156) from the selected cell's registers
RD_FN double dh_ratio(bool diplo, const long long* reg, const bool* fl,
                      bool fwd, long long bpos_i, long long bcnt_i) {
  const long long *o2, *o3;
  bool ok;
  if (!diplo) {
    o2 = reg + LD;
    o3 = reg + LHBD;
    ok = fl[EXD] && fl[EXHBD];
  } else {
    o2 = reg + LH;
    o3 = reg + LDBH;
    ok = fl[EXH] && fl[EXDBH];
  }
  if (!ok) return -RD_INF;
  long long tp = o2[0], tc = o2[1], s2p = o3[0], s2c = o3[1];
  // class_rel.c:134-138: the backward pass swaps s1 and s2
  long long s1p_ = fwd ? bpos_i : s2p, s1c_ = fwd ? bcnt_i : s2c;
  long long s2p_ = fwd ? s2p : bpos_i, s2c_ = fwd ? s2c : bcnt_i;
  double est = (double)s2c_ + (double)wmul(wsub(s1c_, s2c_), wsub(tp, s2p_))
                                  / (double)wsub(s1p_, s2p_);
  double tcf = (double)tc;
  return diplo ? est / tcf : tcf / est;
}

// _lane_step (class_rel.c:279-513) for a live step; writes the 4
// backpointers and returns only_r
RD_FN bool step(State& S, const RowConst& C, long long bpos_i,
                long long bcnt_i, long long epos_i, long long ecnt_i,
                long long max_cc_i, double lf_b_i, double logpE_i,
                const Params& P, signed char bp[4]) {
  double lp[4][4];   // [source cell][target]
  // R target emission (class_rel.c:172-211) from the carried count
  for (int c = 0; c < 4; ++c) {
    long long strc = S.ri[c][SC + REP];
    double lf_strc = RD_LDG(P.lf_small + clampi(strc, 0, P.n1 - 1));
    double lf_sd = RD_LDG(P.lf_small + clampi(strc - bcnt_i, 0, P.n1 - 1));
    double le = bcnt_i < strc
        ? lf_strc - lf_b_i - lf_sd + (double)bcnt_i * P.log_1m_pe_mean
              + (double)(strc - bcnt_i) * P.log_pe_mean
        : -RD_INF;
    double lR = le > P.r_logp
        ? le
        : ((max_cc_i >= C.cov[REP] || max_cc_i >= strc) ? P.r_logp : le);
    // H/D targets: Skellam transitions
    long long sth_p = S.ri[c][SP + HAP], sth_c = S.ri[c][SC + HAP];
    long long std_p = S.ri[c][SP + DIP], std_c = S.ri[c][SC + DIP];
    bool use_ratio = S.dh[c] != -RD_INF;
    long long h_cb = use_ratio ? std_c : sth_c;
    long long h_pos = use_ratio ? std_p : sth_p;
    long long h_ce = use_ratio ? sat_i64(S.dh[c] * (double)bcnt_i) : bcnt_i;
    long long kH = wsub(h_ce, h_cb);
    double lamH = (double)h_cb * (double)wabs(wsub(bpos_i, h_pos - C.PSTEP))
                  / P.read_len;
    long long kD = wsub(bcnt_i, std_c);
    double lamD = (double)std_c * (double)wabs(wsub(bpos_i, std_p - C.PSTEP))
                  / P.read_len;
    double lHv = skellam(kH, lamH, P.tab);
    double lDv = skellam(kD, lamD, P.tab);
    double st4[4] = {logpE_i, lR, lHv, lDv};
    bool dead = S.dp[c] == -RD_INF;
    for (int t = 0; t < 4; ++t) lp[c][t] = dead ? -RD_INF : st4[t];
  }
  // normalisation dropped (argmax-invariant); C special cases kept
  double mc[4];
  for (int c = 0; c < 4; ++c) mc[c] = max4(lp[c][0], lp[c][1], lp[c][2], lp[c][3]);
  double mx = max4(mc[0], mc[1], mc[2], mc[3]);
  bool has_inf = mx == RD_INF;
  bool zero = mx < -745.13;   // C: psum == 0.0 (all exp underflow)
  bool band = false;
  for (int c = 0; c < 4; ++c)
    for (int t = 0; t < 4; ++t) {
      double v = lp[c][t];
      if (has_inf) v = (v == RD_INF) ? RD_NAN : -RD_INF;
      if (zero) v = (t == ERR) ? LOG_QUARTER : -RD_INF;
      // exp-underflow cut (class_rel.c:321-336) + the denormal band flag
      if (v > -745.2 && v < -719.0) band = true;
      if (v < -745.13) v = -RD_INF;
      lp[c][t] = v;
    }
  const double m_band = band ? 1e-30 : RD_INF;

  // ---- only_r (class_rel.c:348-356)
  double sc[4][4];
  for (int c = 0; c < 4; ++c)
    for (int t = 0; t < 4; ++t) sc[c][t] = S.dp[c] + lp[c][t];
  bool rep_s[4];
  double m_or[4];
  bool only_r = true;
  for (int c = 0; c < 4; ++c) {
    int bt;
    double best = maxarg4(sc[c], &bt);
    rep_s[c] = (best == -RD_INF) || (bt == REP);
    only_r = only_r && rep_s[c];
    double srep = sc[c][REP];
    double soth = max4(sc[c][0], -RD_INF, sc[c][2], sc[c][3]);
    double d = fabs(srep - soth);
    if (srep == -RD_INF || soth == -RD_INF) d = RD_INF;
    m_or[c] = isnan_(d) ? 1e-30 : d;
  }
  bool p1 = rep_s[0], p2 = p1 && rep_s[1], p3 = p2 && rep_s[2];
  double m_onlyr = min4(m_or[0], p1 ? m_or[1] : RD_INF, p2 ? m_or[2] : RD_INF,
                        p3 ? m_or[3] : RD_INF);

  // ---- HH/DD coupling (class_rel.c:383-386)
  double colH[4], colD[4];
  for (int c = 0; c < 4; ++c) {
    colH[c] = sc[c][HAP];
    colD[c] = sc[c][DIP];
  }
  int aH, aD;
  double vH = maxarg4(colH, &aH), vD = maxarg4(colD, &aD);
  int maxs_h = vH == -RD_INF ? NST : aH;
  int maxs_d = vD == -RD_INF ? NST : aD;
  bool couple = maxs_h == HAP && maxs_d == DIP;
  double m_coup = min_(bin_margin(colH, HAP), bin_margin(colD, DIP));
  if (couple) {
    double mcoup = min_(lp[HAP][HAP], lp[DIP][DIP]);
    lp[HAP][HAP] = mcoup;
    lp[DIP][DIP] = mcoup;
    for (int c = 0; c < 4; ++c)
      for (int t = 0; t < 4; ++t) sc[c][t] = S.dp[c] + lp[c][t];
  }

  // ---- per-target best predecessor (class_rel.c:390-397)
  double max_v[4], tm[4];
  int max_s[4], sel[4];
  bool dead_t[4];
  for (int t = 0; t < 4; ++t) {
    double col[4] = {sc[0][t], sc[1][t], sc[2][t], sc[3][t]};
    max_v[t] = maxarg4(col, &max_s[t]);
    dead_t[t] = max_v[t] == -RD_INF;
    sel[t] = dead_t[t] ? 0 : max_s[t];
    tm[t] = top2_margin(col);
  }
  double m_sel = min4(tm[0], tm[1], tm[2], tm[3]);

  // guard: the only_r margin always counts; selection/coupling margins
  // only when the step selects; has_inf rows always flag
  double m_poison = has_inf ? 1e-30 : RD_INF;
  double step_margin = min_(min_(m_onlyr, min_(m_band, m_poison)),
                            only_r ? RD_INF : min_(m_coup, m_sel));
  S.mmin = min_(S.mmin, step_margin);
  for (int t = 0; t < 4; ++t)
    bp[t] = (signed char)(only_r ? t : (dead_t[t] ? NST : max_s[t]));

  if (only_r) {
    // only_r overrides (class_rel.c:357-380): same-state copy; dp and
    // eff unchanged, dh cleared
    if (S.dp[HAP] != -RD_INF) {
      S.ri[HAP][LDBH] = S.ri[HAP][LD];
      S.ri[HAP][LDBH + 1] = S.ri[HAP][LD + 1];
      S.ri[HAP][LH] = S.eff[0];
      S.ri[HAP][LH + 1] = S.eff[1];
      S.rb[HAP][EXDBH] = S.rb[HAP][EXD];
      S.rb[HAP][EXH] = true;
      S.rb[HAP][HASH] = true;
    }
    if (S.dp[DIP] != -RD_INF) {
      S.ri[DIP][LHBD] = S.ri[DIP][LH];
      S.ri[DIP][LHBD + 1] = S.ri[DIP][LH + 1];
      S.ri[DIP][LD] = S.eff[0];
      S.ri[DIP][LD + 1] = S.eff[1];
      S.rb[DIP][EXHBD] = S.rb[DIP][EXH];
      S.rb[DIP][EXD] = true;
      S.rb[DIP][HASD] = true;
    }
    for (int s = 0; s < 4; ++s) S.dh[s] = -RD_INF;
    return true;
  }

  // selected predecessor registers (rel_dev2._sel4)
  long long ri[4][NI];
  bool rb[4][NB];
  for (int t = 0; t < 4; ++t) {
    for (int k = 0; k < NI; ++k) ri[t][k] = S.ri[sel[t]][k];
    for (int k = 0; k < NB; ++k) rb[t][k] = S.rb[sel[t]][k];
  }
  const long long oe = epos_i - C.OFF;

  // dh ratios (calc_dh_ratio) for the H and D targets
  double rH = dh_ratio(false, ri[HAP], rb[HAP], C.fwd, bpos_i, bcnt_i);
  double rD = dh_ratio(true, ri[DIP], rb[DIP], C.fwd, bpos_i, bcnt_i);

  // HAPLO target (class_rel.c:426-459)
  long long curr_h_H = ecnt_i;
  long long curr_d_H = rH != -RD_INF
      ? sat_i64(rH * (double)curr_h_H)
      : (rb[HAP][HASD] ? ri[HAP][SC + DIP] : curr_h_H + C.covH);
  long long curr_r_H = sat_i64(P.dr_ratio * (double)curr_d_H);
  // DIPLO target (class_rel.c:460-493)
  long long curr_d_D = ecnt_i;
  long long curr_h_D = rD != -RD_INF
      ? sat_i64((double)curr_d_D / rD)
      : (rb[DIP][HASH] ? ri[DIP][SC + HAP]
                       : maxi(floordiv2(curr_d_D), curr_d_D - C.covH));
  long long curr_r_D = sat_i64(P.dr_ratio * (double)curr_d_D);

  // REPEAT target st (class_rel.c:413-425)
  long long r_cnt = mini(ecnt_i, C.covR);
  bool keep_r = ri[REP][SC + REP] < r_cnt;
  ri[REP][SP + HAP] = oe;
  ri[REP][SP + DIP] = oe;
  if (!keep_r) {
    ri[REP][SP + REP] = oe;
    ri[REP][SC + REP] = r_cnt;
  }
  for (int k = 1; k < 4; ++k) {
    ri[HAP][SP + k] = oe;
    ri[DIP][SP + k] = oe;
  }
  ri[HAP][SC + REP] = curr_r_H;
  ri[HAP][SC + HAP] = curr_h_H;
  ri[HAP][SC + DIP] = curr_d_H;
  ri[DIP][SC + REP] = curr_r_D;
  ri[DIP][SC + HAP] = curr_h_D;
  ri[DIP][SC + DIP] = curr_d_D;

  for (int t = 0; t < 4; ++t) {
    // H<D<R gate on the new counts
    bool gate = ri[t][SC + HAP] < ri[t][SC + DIP]
                && ri[t][SC + DIP] < ri[t][SC + REP];
    S.dp[t] = (dead_t[t] || !gate) ? -RD_INF : max_v[t];
    // path registers: extend with target t (order: read before write)
    if (t == DIP) {
      ri[t][LHBD] = ri[t][LH];
      ri[t][LHBD + 1] = ri[t][LH + 1];
      rb[t][EXHBD] = rb[t][EXH];
      ri[t][LD] = epos_i;
      ri[t][LD + 1] = ecnt_i;
      rb[t][EXD] = true;
      rb[t][HASD] = true;
    }
    if (t == HAP) {
      ri[t][LDBH] = ri[t][LD];
      ri[t][LDBH + 1] = ri[t][LD + 1];
      rb[t][EXDBH] = rb[t][EXD];
      ri[t][LH] = epos_i;
      ri[t][LH + 1] = ecnt_i;
      rb[t][EXH] = true;
      rb[t][HASH] = true;
    }
    for (int k = 0; k < NI; ++k) S.ri[t][k] = ri[t][k];
    for (int k = 0; k < NB; ++k) S.rb[t][k] = rb[t][k];
  }
  S.dh[ERR] = -RD_INF;
  S.dh[REP] = -RD_INF;
  S.dh[HAP] = rH;
  S.dh[DIP] = rD;
  S.eff[0] = epos_i;
  S.eff[1] = ecnt_i;
  return false;
}

// One row: init, its own m-1 steps, traceback (class_rel.c:606-613)
RD_FN void row(const Args& a, int b) {
  if (a.active && !a.active[b]) return;
  const int M = a.max_m;
  const long long o = (long long)b * M;
  RowConst C;
  for (int k = 0; k < 4; ++k) C.cov[k] = a.cov[(long long)b * 4 + k];
  C.fwd = a.fwd[b] != 0;
  C.OFF = C.fwd ? a.P.offset : -a.P.offset;
  C.PSTEP = C.fwd ? 1 : -1;
  C.covR = C.cov[REP];
  C.covH = C.cov[HAP];
  const long long m = a.m[b];

  State S;
  init_cell(S, C, a.plen[b], a.bcnt[o], a.ecnt[o], a.epos[o], a.max_cc[o],
            a.lf_bcnt[o], a.logpE[o], a.P);
  signed char* bp = a.bp + (long long)b * (M - 1) * 4;
  unsigned char* rpos = a.rpos + o;
  rpos[0] = 0;
  for (long long i = 1; i < m; ++i) {
    bool only_r = step(S, C, a.bpos[o + i], a.bcnt[o + i], a.epos[o + i],
                       a.ecnt[o + i], a.max_cc[o + i], a.lf_bcnt[o + i],
                       a.logpE[o + i], a.P, bp + (i - 1) * 4);
    rpos[i] = only_r ? 1 : 0;
  }

  // row margin: min FIRST, then the all-dead force flag (an exact-tie
  // step margin of 0.0 must not mask it)
  double mm = min_(S.mmin, top2_margin(S.dp));
  if (S.dp[0] == -RD_INF && S.dp[1] == -RD_INF && S.dp[2] == -RD_INF
      && S.dp[3] == -RD_INF)
    mm = 1e-30;
  a.mm_out[b] = mm;
  for (int s = 0; s < 4; ++s) a.dp_out[(long long)b * 4 + s] = S.dp[s];

  int cur;
  maxarg4(S.dp, &cur);
  const long long last = m - 1 > 0 ? m - 1 : 0;
  signed char* asgn = a.asgn + o;
  for (long long j = M - 1; j > last; --j) asgn[j] = (signed char)cur;
  for (long long j = last; j >= 1; --j) {
    asgn[j] = (signed char)cur;
    int cc = cur < 0 ? 0 : (cur > 3 ? 3 : cur);
    cur = bp[(j - 1) * 4 + cc];
  }
  asgn[0] = (signed char)cur;
  for (long long j = 1; j < m && j < M; ++j)
    if (rpos[j]) asgn[j] = REP;
}

}  // namespace rd
