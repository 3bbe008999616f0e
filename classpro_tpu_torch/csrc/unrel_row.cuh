// The two relaxation sweeps for ONE read row: the descending sweep, then
// the ascending one, each step re-deciding one unreliable interval from
// its nearest reliable H/D neighbours.  Shared by the CUDA kernel
// (unrel.cu, nvcc) and the host test shim (the same file under g++), so
// the CPU tests exercise the arithmetic the card runs.
//
// Replaces the JAX package's unrel_dev2.unrel_sweeps2 (unrel_dev2.py:67)
// with _unrel_lane's step_fn (:157-279), class_unrel.c:248-300.  Semantics
// follow the JAX code line for line; classpro_tpu_torch/unrel_ref.py is
// the plain torch version.  The log-Skellam lookup is rd::skellam, the
// same function the DP kernel (rel_dp_row.cuh) inlines (rd_math.cuh).
//
// Numerics (built with --fmad=false / -ffp-contract=off, never fast
// math): every expression keeps the JAX code's operation order; maxima
// propagate NaN; the argmax takes the first NaN, else the first maximum
// (jnp.argmax); the margin is rd::top2_margin; float -> int64 casts
// saturate (NaN -> 0) and are evaluated only on the branch that is taken;
// int64 arithmetic wraps; _div_cr is plain IEEE division.  Values read
// from the planes gain +0.0, as the JAX code's one-hot sums do.

#pragma once

#include "rd_math.cuh"

namespace ur {

using rd::DIP;
using rd::HAP;
using rd::REP;

// plane order in the per-interval static value tensor P13
enum { CB = 0, CE, LFCB, LFCE, XL, XR, LE, POHB, POHE, PODB, PODE, PEOB,
       PEOE, NP };

struct Params {
  const double* tab;       // (NMAX+1, NCOL, 5) packed Skellam table
  const double* lf_small;  // (n1,) logfact head
  int n1;
  const double* btg_flat;  // (n_cap*n_cap,) log binomial tail, erate 0.1
  int n_cap;
  double read_len, r_logp, log_1m_pe_mean, log_pe_mean, dr_ratio;
  long long cov_r, cov_h, cov_d;
};

struct Args {
  const unsigned char* is_rel;   // (B, N) bool
  const int* asgn0;              // (B, N) int32, values in [0, 4]
  const double* P13;             // (B, N, 13)
  const double *packL, *packR;   // (B, N, 3)
  const int *idx_desc, *idx_asc; // (B, N) step -> interval
  const unsigned char* live;     // (B, N) bool, step runs
  const int* n;                  // (B,)
  signed char* asgn;             // out (B, N): the row's working assignment
  double* mm_out;                // out (B,)
  int B, N;
  Params P;
};

// jnp.argmax over 4: the first NaN, else the first maximum
RD_FN int argmax4(const double x[4]) {
  for (int k = 0; k < 4; ++k)
    if (rd::isnan_(x[k])) return k;
  int i;
  rd::maxarg4(x, &i);
  return i;
}

RD_FN double lf_at(const Params& P, long long i) {
  return RD_LDG(P.lf_small + rd::clampi(i, 0, P.n1 - 1));
}

// One step deciding interval idx of row b (a live step whose interval is
// not a fixed reliable H/D): updates the working row, returns the margin.
RD_FN double step(const Args& a, int b, int idx) {
  const Params& P = a.P;
  const int N = a.N;
  const long long o = (long long)b * N;
  const long long nrow = a.n[b];
  signed char* w = a.asgn + o;
  const unsigned char* rel = a.is_rel + o;
  const double NINF = -RD_INF;

  const int nb = idx - 1 >= 0 ? w[idx - 1] : 0;
  const int na = idx + 1 < N ? w[idx + 1] : 0;
  double v[NP];
  for (int k = 0; k < NP; ++k) v[k] = a.P13[(o + idx) * NP + k] + 0.0;
  const long long icb = rd::sat_i64(v[CB]), ice = rd::sat_i64(v[CE]);
  const double x_l = v[XL], x_r = v[XR], lE = v[LE];

  // ---- nearest reliable H/D neighbours (class_unrel.c:11-25): linear
  // scans outward from idx over is_rel & asgn in {H, D}
  long long lH = -1, lD = -1, rH = -1, rD = -1;
  const long long lim = nrow < N ? nrow : N;
  for (long long c = (idx - 1 < lim - 1 ? idx - 1 : lim - 1);
       c >= 0 && (lH < 0 || lD < 0); --c) {
    if (!rel[c]) continue;
    if (w[c] == HAP && lH < 0) lH = c;
    if (w[c] == DIP && lD < 0) lD = c;
  }
  for (long long c = idx + 1; c < lim && (rH < 0 || rD < 0); ++c) {
    if (!rel[c]) continue;
    if (w[c] == HAP && rH < 0) rH = c;
    if (w[c] == DIP && rD < 0) rD = c;
  }
  // slot order [H-left, H-right, D-left, D-right]; left slots read packL
  // = (cce, e-1, ce), right slots packR = (ccb, b, cb)
  const long long J4[4] = {lH, rH, lD, rD};
  bool nn_ok[4];
  double V4[4][3];
  for (int j = 0; j < 4; ++j) {
    nn_ok[j] = J4[j] != -1;
    const double* pk = (j % 2 == 0) ? a.packL : a.packR;
    for (int k = 0; k < 3; ++k)
      V4[j][k] = nn_ok[j] ? pk[(o + J4[j]) * 3 + k] + 0.0 : 0.0;
  }

  // ---- logp_r_u (class_unrel.c:67-113): uncorrected neighbour counts
  const double cov_d_f = (double)P.cov_d;
  const double dl = nn_ok[2] ? V4[2][2] : (nn_ok[3] ? V4[3][2] : cov_d_f);
  const double dr = nn_ok[3] ? V4[3][2] : (nn_ok[2] ? V4[2][2] : cov_d_f);
  const long long rlrr[2] = {rd::sat_i64(P.dr_ratio * dl),
                             rd::sat_i64(P.dr_ratio * dr)};
  const long long k2[2] = {icb, ice};
  const bool over = k2[0] >= rlrr[0] || k2[1] >= rlrr[1];
  const double lf2[2] = {v[LFCB], v[LFCE]};
  double bi2[2];
  for (int s = 0; s < 2; ++s) {
    const long long d = rd::wsub(rlrr[s], k2[s]);
    bi2[s] = lf_at(P, rlrr[s]) - lf2[s] - lf_at(P, d)
             + (double)k2[s] * P.log_1m_pe_mean + (double)d * P.log_pe_mean;
  }
  const double lp_r = bi2[0] + bi2[1];
  const bool hi = rd::maxi(icb, ice) >= P.cov_r;
  const double lR = hi ? 0.0 : (over ? P.r_logp : lp_r);

  // ---- est_cov for (H,D) x (left,right) lanes (class_unrel.c:27-43)
  const double xq4[4] = {x_l, x_r, x_l, x_r};
  long long val4[4];
  bool found4[4];
  for (int j = 0; j < 4; ++j) {
    const int sl = (j < 2) ? 0 : 2, sr = sl + 1;   // this state's slots
    const bool l_ok = nn_ok[sl], r_ok = nn_ok[sr];
    const double Lc = V4[sl][0], Le = V4[sl][1];
    const double Rc = V4[sr][0], Rb = V4[sr][1];
    if (l_ok && r_ok)
      val4[j] = rd::sat_i64(Lc + ((Rc - Lc) * (xq4[j] - Le)) / (Rb - Le));
    else
      val4[j] = l_ok ? rd::sat_i64(Lc) : (r_ok ? rd::sat_i64(Rc) : 0);
    found4[j] = l_ok || r_ok;
  }
  // cross-state fallback: the other state's value on the same side
  long long estf[4];
  for (int j = 0; j < 4; ++j) {
    const int oj = (j + 2) % 4;
    if (found4[j])
      estf[j] = val4[j];
    else if (found4[oj] && val4[oj] > 0)
      estf[j] = j < 2 ? rd::floordiv2(val4[oj]) : rd::wmul(val4[oj], 2);
    else
      estf[j] = j < 2 ? P.cov_h : P.cov_d;
  }

  // ---- Skellam drifts to the neighbours, binomial tails at the
  // estimated coverages
  const long long cnt4[4] = {icb, ice, icb, ice};
  double sk[4], sfe[4];
  for (int j = 0; j < 4; ++j) {
    long long kk = rd::wsub(cnt4[j], rd::sat_i64(V4[j][0]));
    if (j % 2) kk = rd::wsub(0, kk);
    const double lamm = V4[j][0] * fabs(xq4[j] - V4[j][1]) / P.read_len;
    sk[j] = rd::skellam(kk, lamm, P.tab);
    const long long nq = rd::clampi(estf[j], 1, P.n_cap - 1);
    const long long kq = rd::clampi(rd::wsub(estf[j], cnt4[j]), 0,
                                    P.n_cap - 1);
    const double t = RD_LDG(P.btg_flat + (int)(nq * P.n_cap + kq));
    sfe[j] = estf[j] >= cnt4[j] ? t : NINF;
  }

  // ---- per-state side combination (class_unrel.c:115-183)
  double lHD[2];
  for (int s = 0; s < 2; ++s) {
    const int S = s == 0 ? HAP : DIP;
    const double er_l = (idx - 1 >= 0 && nb == S) ? v[PEOB] : NINF;
    const double er_r = ((long long)idx + 1 < nrow && na == S) ? v[PEOE]
                                                                : NINF;
    const double sf_l = nn_ok[2 * s] ? sk[2 * s] : NINF;
    const double sf_r = nn_ok[2 * s + 1] ? sk[2 * s + 1] : NINF;
    const double logp_l = rd::max_(rd::max_(er_l, sf_l), sfe[2 * s]);
    const double logp_r = rd::max_(rd::max_(er_r, sf_r), sfe[2 * s + 1]);
    const double po_b = s == 0 ? v[POHB] : v[PODB];
    const double po_e = s == 0 ? v[POHE] : v[PODE];
    const bool l_inf = logp_l == NINF, r_inf = logp_r == NINF;
    const bool both_inf = l_inf && r_inf;
    const double lpl = both_inf ? po_b : (l_inf ? logp_r : logp_l);
    const double lpr = both_inf ? po_e : (r_inf ? lpl : logp_r);
    lHD[s] = lpl + lpr;
  }

  const double cand[4] = {lE, lR, lHD[0], lHD[1]};
  const bool force_r = rd::maxi(icb, ice) >= P.cov_r;
  w[idx] = (signed char)(force_r ? REP : argmax4(cand));
  // exactness-guard margin; a forced REPEAT is an exact int compare
  return force_r ? RD_INF : rd::top2_margin(cand);
}

// One row: both sweeps, then the row's minimum margin
RD_FN void row(const Args& a, int b) {
  const int N = a.N;
  const long long o = (long long)b * N;
  const long long nrow = a.n[b];
  for (int c = 0; c < N; ++c) a.asgn[o + c] = (signed char)a.asgn0[o + c];
  double mm = RD_INF;
  for (int sweep = 0; sweep < 2; ++sweep) {
    const int* xs = (sweep == 0 ? a.idx_desc : a.idx_asc) + o;
    for (int t = 0; t < N; ++t) {
      if (!a.live[o + t]) continue;
      const int idx = xs[t];
      if (idx < 0 || idx >= N) continue;
      // a reliable interval fixed at H/D is never re-decided (inactive)
      const int s0 = a.asgn0[o + idx];
      if (a.is_rel[o + idx] && idx < nrow && (s0 == HAP || s0 == DIP))
        continue;
      mm = rd::min_(mm, step(a, b, idx));
    }
  }
  a.mm_out[b] = mm;
}

}  // namespace ur
