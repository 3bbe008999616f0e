// Reliable-interval Viterbi DP for one warp of rows, eight lanes per row:
// two groups of four, lane c of each group owning DP cell (state) c and
// its path registers; the groups mirror each other and split the step's
// two Skellam lookups.  Shared by the CUDA kernel (rel_dp.cu, nvcc: one
// thread is one lane) and the host test shim (the same file under g++ -x
// c++: one call runs a warp's 32 lanes, phase by phase), so the CPU tests
// exercise the arithmetic and the lane exchanges the card runs.
//
// Replaces the JAX package's rel_dev2._lane_init (:224), _lane_step
// (:318) inside the while loop of rel_dp_pass2 (:636-720), the inlined
// skellam_dev.skellam_args/skellam_value lookup (:284-323) and the
// traceback (rel_dev2.py:723-785).  Semantics follow the JAX code line
// for line; classpro_tpu_torch/rel_ref.py is the plain torch version.
//
// One step of a row (warp_rows):
//   (A) phase_a, half h on group h: cell c's H (h 0) or D (h 1) Skellam
//       transition (its table gather issued first), its R emission, and
//       cell c's update of the H (h 0) or D (h 1) target were c its
//       predecessor (the dh ratio and the new counts: cand);
//   exchange 0: the two groups swap halves; join: lp[c][0..3] and cand;
//   exchange 1: the row maxima max4(lp[k][.]);
//   (B1) phase_b1, row c: the special cases (has_inf, all-underflow, the
//       exp-underflow cut and denormal band), sc[c][.], row c's only_r terms;
//   exchange 2: the row's only_r terms, the H and D columns, the two coupled
//       terms, and column c of sc (a 4 x 4 transpose in three shuffles);
//   (B2) phase_b2, target c: only_r and the HH/DD coupling (alike on every
//       lane), target c's best predecessor sel[c] and margins;
//   exchange 3: lane c takes lane sel[c]'s registers and cand;
//   (C) phase_c: lane c updates its own cell.
// Before the loop, on the main path's first pass, the row's lanes write its
// planes from the chunk's blobs (prologue; the cell is prep_cell.cuh's).
// After the loop, one lane per row runs the traceback, and the row's lanes
// run its tails (row_tails: the rescue predicate on the first pass, the
// packed row on the main path's two passes; rel_tail.cuh).
// No tree reduction reorders a NaN-propagating max_ or the first-wins
// maxarg4: a lane gathers the four values and runs the reference's
// expression.  Every value a lane holds is a scalar or a statically indexed
// array, so nothing lives in local memory.  Lanes whose row has ended (or
// is masked off, or lies past R2) stay in the loop, predicated, until the
// longest row of the warp ends: every exchange has all 32 lanes.
//
// Numerics as rd_math.cuh: operation order kept, NaN-propagating maxima,
// saturating casts, IEEE division.

#pragma once

#include "prep_cell.cuh"
#include "rd_math.cuh"
#include "rel_tail.cuh"
#include "warp_lanes.cuh"

namespace rd {

// A row's lanes: two groups of 4, lane c of each group holding cell c;
// the groups mirror each other and split phase A's two Skellam lookups.
constexpr int CELLS = 4;
constexpr int LANES = 2 * CELLS;   // lanes per DP row
constexpr int ROWS_PER_WARP = WARP / LANES;
constexpr double LOG_QUARTER = -1.3862943611198906;  // log(0.25)
// The tails' column trips whose loads go out together (a tail's time is
// its loads' latency, one warp per SM): every load of a batch is issued,
// in bounds whether used or not, before any is used.  A batch of the
// rescue tail covers 8 x 8 columns (five loads a column), of the pack
// tail 16 x 8 (one byte a column).
constexpr int RESCUE_BATCH = 8;
constexpr int PACK_BATCH = 16;
// The prologue's column trips whose blob loads go out together (4 x 8
// columns, five loads a column, then two log-factorial loads a column):
// on the H100, batches of 1, 2, 8 and 16 trips took longer (PERF.md).
constexpr int PREP_BATCH = 4;

// path-register slots (rel_dev2.py regs_i / regs_b)
enum { SP = 0, SC = 4, LH = 8, LD = 10, LHBD = 12, LDBH = 14, NI = 16 };
enum { EXH = 0, EXD = 1, EXHBD = 2, EXDBH = 3, HASH = 4, HASD = 5, NB = 6 };

struct Params {
  const double* tab;       // (NMAX+1, NCOL, 5) packed Skellam table
  const double* lf_small;  // (n1,) logfact head
  int n1;
  double read_len;
  long long offset;
  double r_logp, log_1m_pe_mean, log_pe_mean, dr_ratio;
};

// The chunk's blobs (main layout, prep_cell.cuh), from which the main
// path's first pass writes its planes (prologue); a null iblob: the planes
// are given.
struct Blobs {
  const int* iblob;        // b, e, ccb, cce [4 x R*max_m] | m [R] | plen [R]
  const double* fblob;     // pe [R*max_m]
  const double* logfact;   // (32768,)
  double e_po_base;
};

struct Args {
  // (R2, max_m) planes in scan order: inputs, or, on a pass with blobs,
  // the prologue's outputs
  long long *bpos, *bcnt, *epos, *ecnt, *max_cc;
  double *lf_bcnt, *logpE;
  long long *m, *plen;             // (R2,)
  unsigned char* fwd;              // (R2,)
  long long* cov;                  // (R2, 4)
  const unsigned char* active;     // (R2,) or null (all rows)
  signed char* asgn;               // out (R2, max_m)
  double* dp_out;                  // out (R2, 4)
  double* mm_out;                  // out (R2,)
  signed char* bp;                 // scratch (R2, max_m-1, 4)
  unsigned char* rpos;             // scratch (R2, max_m)
  // the row tails (rel_tail.cuh, row_tails); a null output skips its tail
  unsigned char* rescue;           // out (R2,): the rescue predicate
  long long* cov2;                 // out (R2, 4): the rescue pass's coverages
  const long long* gcov;           // (4,) the model's coverages
  unsigned char* packed;           // out (R2, max_m + 5): the packed rows
  const double* mm_prev;           // (R2,) the first pass's margins: set
                                   // on the rescue pass, null on the first
  Blobs blob;
  int R2, max_m;
  Params P;
};

// Where a row keeps its backpointers and only_r flags for the traceback:
// row b at bp + (b - row0) * (max_m-1) * 4 and rpos + (b - row0) * max_m
// (shared memory of the block, or the global scratch of Args).
struct Scratch {
  signed char* bp;
  unsigned char* rpos;
  int row0;
};

struct RowConst {
  long long cov[4];
  bool fwd;
  long long OFF, PSTEP, covR, covH;
};

// One lane: cell c of row b.
struct Lane {
  int c;                   // the DP state this lane owns
  int h;                   // its group in the row (0: writes the outputs)
  int row;                 // b, clamped into [0, R2) for the plane loads
  bool valid;              // b < R2 and the row is active
  long long m;
  RowConst C;
  double dp, dh;           // cell c's score and dh ratio
  long long ri[NI];        // cell c's path registers
  unsigned rb;             // cell c's NB flags, bit k = regs_b[k]
  long long eff0, eff1;    // row values, alike on the row's lanes
  double mmin;             // this lane's running decision margin
};

// The state-independent plane values of one step.
struct StepIn {
  long long bpos, bcnt, epos, ecnt, max_cc;
  double lf_b, logpE;
};

struct Row {               // lane c's row of the step's terms
  double lp[4];            // lp[c][target]
};

// Cell c's updates of the H and D targets, were it their selected
// predecessor: the dh ratios and the new counts (class_rel.c:426-493).
// Lane c computes them in phase A, beside its lookups; the H and D lanes
// take them from their selected predecessor with its registers.
struct Cand {
  double rH, rD;           // dh ratio of the H target / of the D target
  long long dH, rH_cnt;    // the H target's new D and R counts
  long long hD;            // the D target's new H count
};

struct RowB {              // lane c's row after the special cases
  double lp[4], sc[4];     // lp[c][.] cut, sc[c][.] = dp[c] + lp[c][.]
  double m_or;             // its only_r margin
  bool has_inf, band, rep_s;
};

struct Gath {              // what phase B2 takes from the row's lanes
  double m_or[4];          // m_or[k]
  double colH[4], colD[4]; // sc[k][HAP], sc[k][DIP]
  double lpHH, lpDD;       // lp[HAP][HAP], lp[DIP][DIP]
  double col[4];           // sc[k][c]: this lane's target column
  unsigned rep_s, band;    // bit k: row k's rep_s / band
};

struct Dec {               // phase B's decisions for target c
  bool only_r, dead;
  int sel;
  double max_v;
  signed char bp;
};

struct Regs {              // a cell's path registers in flight
  long long ri[NI];
  unsigned rb;
  Cand q;
};

RD_FN bool flag(unsigned rb, int k) { return (rb >> k) & 1u; }
RD_FN unsigned with_flag(unsigned rb, int k, bool v) {
  return v ? (rb | (1u << k)) : (rb & ~(1u << k));
}
template <class T>
RD_FN T pick4(const T x[4], int c) {
  T v = x[0];
  RD_UNROLL
  for (int k = 1; k < 4; ++k)
    if (c == k) v = x[k];
  return v;
}

// The row's 4 x 4 matrix, lane c holding row c, transposed: out[l][k] =
// row[k][c_l].  Round r: lane c sends its entry (c - r) & 3 and takes lane
// (c + r) & 3's, which is that lane's entry c.
template <int NL>
RD_FN void transpose4(const double (&row)[NL][4], const int (&wl)[NL],
                      double (&out)[NL][4]) {
  double rot[NL][4];
  for (int l = 0; l < NL; ++l) rot[l][0] = pick4(row[l], wl[l] & 3);
  RD_UNROLL
  for (int r = 1; r < 4; ++r) {
    int src[NL];
    double v[NL], o[NL];
    for (int l = 0; l < NL; ++l) {
      const int c = wl[l] & 3;
      src[l] = (wl[l] & ~(CELLS - 1)) + ((c + r) & 3);
      v[l] = pick4(row[l], (c - r) & 3);
    }
    xchg<NL>(v, src, o);
    for (int l = 0; l < NL; ++l) rot[l][r] = o[l];
  }
  // rot[r] is row[(c + r) & 3][c]
  for (int l = 0; l < NL; ++l) {
    const int c = wl[l] & 3;
    RD_UNROLL
    for (int k = 0; k < 4; ++k) out[l][k] = pick4(rot[l], (k - c) & 3);
  }
}

// A plane value: through the non-coherent read-only path where another
// launch wrote the planes, with a plain load in the launch whose prologue
// wrote them (PRO), after the warp_sync that orders the prologue's stores:
// the read-only path may return stale bytes of a line this launch wrote.
template <bool PRO, class T>
RD_FN T ld_plane(const T* p) {
  if constexpr (PRO)
    return *p;
  else
    return RD_LDG(p);
}

template <bool PRO>
RD_FN StepIn load_step(const Args& a, int row, long long i) {
  const long long o = (long long)row * a.max_m + i;
  StepIn s;
  s.bpos = ld_plane<PRO>(a.bpos + o);
  s.bcnt = ld_plane<PRO>(a.bcnt + o);
  s.epos = ld_plane<PRO>(a.epos + o);
  s.ecnt = ld_plane<PRO>(a.ecnt + o);
  s.max_cc = ld_plane<PRO>(a.max_cc + o);
  s.lf_b = ld_plane<PRO>(a.lf_bcnt + o);
  s.logpE = ld_plane<PRO>(a.logpE + o);
  return s;
}

// The main path's first pass, before its step loop: each row's planes
// from the chunk's blobs (device_pipeline._rel_only_core :572-626 and the
// E emission of _rel_pipeline :170-174; rel.prep_ref), by the row's eight
// lanes, lane j taking columns j, j + 8, ...  A backward row reads its
// forward row's blob at the reversed column, so no row waits on another.
// One warp per SM hides little latency, so the blob loads of PREP_BATCH
// trips go out (in bounds whether used or not) before any is used, then
// their log-factorial loads; log(covE) is taken once per lane.  Lane 0 of
// a row writes its m, plen, fwd and coverages.  The step loop reads the
// planes after warp_sync, with plain loads (ld_plane<true>).
template <int NL>
RD_FN void prologue(const Args& a, int g0) {
  const int M = a.max_m, R = a.R2 / 2;
  const long long RM = (long long)R * M;
  const int* ib = a.blob.iblob;
  const double covEf = (double)RD_LDG(a.gcov + ERR);
  const double lce = log(covEf);
  for (int l = 0; l < NL; ++l) {
    const int g = g0 + l, b = g / LANES, j = g % LANES;
    if (b >= a.R2) continue;
    const bool bw = b >= R;
    const int r = bw ? b - R : b;
    const long long mr = RD_LDG(ib + 4 * RM + r);
    const long long src = (long long)r * M;
    for (int c0 = 0; c0 < M; c0 += PREP_BATCH * LANES) {
      int vb[PREP_BATCH], ve[PREP_BATCH], vcb[PREP_BATCH], vce[PREP_BATCH];
      double pe[PREP_BATCH], lb[PREP_BATCH], le[PREP_BATCH];
      RD_UNROLL
      for (int t = 0; t < PREP_BATCH; ++t) {
        const int c = c0 + t * LANES + j;
        const long long i = src + gl::main_col(bw, c < M ? c : M - 1, mr);
        vb[t] = RD_LDG(ib + i);
        ve[t] = RD_LDG(ib + RM + i);
        vcb[t] = RD_LDG(ib + 2 * RM + i);
        vce[t] = RD_LDG(ib + 3 * RM + i);
        pe[t] = RD_LDG(a.blob.fblob + i);
      }
      RD_UNROLL
      for (int t = 0; t < PREP_BATCH; ++t) {
        lb[t] = gl::lf_at(a.blob.logfact, gl::main_bcnt(bw, vcb[t], vce[t]));
        le[t] = gl::lf_at(a.blob.logfact, gl::main_ecnt(bw, vcb[t], vce[t]));
      }
      RD_UNROLL
      for (int t = 0; t < PREP_BATCH; ++t) {
        const int c = c0 + t * LANES + j;
        if (c >= M) continue;
        const gl::MainCell o = gl::main_cell(
            bw, vb[t], ve[t], vcb[t], vce[t], pe[t], lb[t], le[t], covEf,
            lce, a.blob.e_po_base);
        const long long k = (long long)b * M + c;
        a.bpos[k] = o.bpos;
        a.bcnt[k] = o.bcnt;
        a.epos[k] = o.epos;
        a.ecnt[k] = o.ecnt;
        a.max_cc[k] = o.max_cc;
        a.lf_bcnt[k] = o.lf_bcnt;
        a.logpE[k] = o.logpE;
      }
    }
    if (j != 0) continue;
    a.m[b] = mr;
    a.plen[b] = RD_LDG(ib + 4 * RM + R + r);
    a.fwd[b] = bw ? 0 : 1;
    RD_UNROLL
    for (int q = 0; q < 4; ++q) a.cov[4LL * b + q] = RD_LDG(a.gcov + q);
  }
}

// _lane_init (class_rel.c:544-595) for cell L.c; every lane of the row
// computes the four initial scores (the softmax kill needs them all)
RD_FN void init_lane(Lane& L, long long plen, const StepIn& s0,
                     const Params& P) {
  const RowConst& C = L.C;
  const int c = L.c;
  const double covHf = (double)C.cov[HAP], covDf = (double)C.cov[DIP];
  const long long pos_init = C.fwd ? -P.offset : plen + P.offset;
  const long long bcnt0 = s0.bcnt, ecnt0 = s0.ecnt, epos0 = s0.epos;
  const double lf_b0 = s0.lf_b;
  RD_UNROLL
  for (int k = 0; k < 4; ++k) {
    L.ri[SP + k] = pos_init;
    L.ri[SC + k] = C.cov[k];
  }
  RD_UNROLL
  for (int k = 8; k < NI; ++k) L.ri[k] = 0;
  L.rb = 0;
  const long long covR = C.covR;
  double lf_r = RD_LDG(P.lf_small + clampi(covR, 0, P.n1 - 1));
  double lf_rd = RD_LDG(P.lf_small + clampi(covR - bcnt0, 0, P.n1 - 1));
  double logp_er = bcnt0 < covR
      ? lf_r - lf_b0 - lf_rd + (double)bcnt0 * P.log_1m_pe_mean
            + (double)(covR - bcnt0) * P.log_pe_mean
      : -RD_INF;
  double dpR = logp_er > P.r_logp
      ? logp_er
      : ((s0.max_cc >= C.cov[REP] || s0.max_cc >= covR) ? P.r_logp : logp_er);
  double dpH = (double)bcnt0 * log(covHf) - covHf - lf_b0;
  double dpD = (double)bcnt0 * log(covDf) - covDf - lf_b0;
  if (c == REP) {
    L.ri[SP + REP] = epos0;
    L.ri[SC + REP] = mini(ecnt0, covR);
  } else if (c == HAP) {
    L.ri[SP + HAP] = epos0;
    L.ri[SC + HAP] = ecnt0;
    L.ri[SP + DIP] = epos0 - C.OFF;
    L.ri[SC + DIP] = ecnt0 + C.covH;
    L.ri[LH] = epos0;
    L.ri[LH + 1] = ecnt0;
    L.rb = (1u << EXH) | (1u << HASH);
  } else if (c == DIP) {
    L.ri[SP + HAP] = epos0 - C.OFF;
    L.ri[SC + HAP] = maxi(floordiv2(ecnt0), ecnt0 - C.covH);
    L.ri[SP + DIP] = epos0;
    L.ri[SC + DIP] = ecnt0;
    L.ri[LD] = epos0;
    L.ri[LD + 1] = ecnt0;
    L.rb = (1u << EXD) | (1u << HASD);
  }

  double dp0[4] = {s0.logpE, dpR, dpH, dpD};
  // init normalisation: a state whose softmax probability underflows to
  // exactly 0.0 is dead (discrete kill, fuzz seed 21517)
  double p0[4];
  RD_UNROLL
  for (int s = 0; s < 4; ++s) p0[s] = exp(dp0[s]);
  double psum = ((p0[0] + p0[1]) + p0[2]) + p0[3];
  bool near = false;
  double lps = log(psum);
  RD_UNROLL
  for (int s = 0; s < 4; ++s) {
    double v0 = p0[s] / psum;
    if (!(v0 > 0.0)) dp0[s] = -RD_INF;     // nan/0 -> dead, like C
    double t0 = dp0[s] - lps;
    if (fabs(t0 + 745.1332) < 0.1) near = true;
  }
  bool degen = (psum == 0.0) || !isfinite_(psum);
  L.mmin = (near || degen) ? 1e-30 : RD_INF;
  L.dp = pick4(dp0, c);
  L.dh = -RD_INF;
  L.eff0 = epos0;
  L.eff1 = ecnt0;
}

// binary margin of row idx topping column col (the coupling trigger)
RD_FN double bin_margin(const double col[4], int idx) {
  double own = col[idx];
  double o[4];
  RD_UNROLL
  for (int c = 0; c < 4; ++c) o[c] = (c == idx) ? -RD_INF : col[c];
  double oth = max4(o[0], o[1], o[2], o[3]);
  double d = fabs(own - oth);
  if (own == -RD_INF || oth == -RD_INF) d = RD_INF;
  return isnan_(d) ? 1e-30 : d;
}

// calc_dh_ratio (class_rel.c:113-156) from the selected cell's registers
// (H target: diplo false; D target: true), one division for either
RD_FN double dh_ratio(bool diplo, const long long ri[NI], unsigned rb,
                      bool fwd, long long bpos_i, long long bcnt_i) {
  const bool ok = diplo ? (flag(rb, EXH) && flag(rb, EXDBH))
                        : (flag(rb, EXD) && flag(rb, EXHBD));
  long long tp = diplo ? ri[LH] : ri[LD];
  long long tc = diplo ? ri[LH + 1] : ri[LD + 1];
  long long s2p = diplo ? ri[LDBH] : ri[LHBD];
  long long s2c = diplo ? ri[LDBH + 1] : ri[LHBD + 1];
  // class_rel.c:134-138: the backward pass swaps s1 and s2
  long long s1p_ = fwd ? bpos_i : s2p, s1c_ = fwd ? bcnt_i : s2c;
  long long s2p_ = fwd ? s2p : bpos_i, s2c_ = fwd ? s2c : bcnt_i;
  double est = (double)s2c_ + (double)wmul(wsub(s1c_, s2c_), wsub(tp, s2p_))
                                  / (double)wsub(s1p_, s2p_);
  double tcf = (double)tc;
  double q = (diplo ? est : tcf) / (diplo ? tcf : est);   // est/tc or tc/est
  return ok ? q : -RD_INF;
}

// Half h of cell L.c's step terms (_lane_step, class_rel.c:172-211,
// 279-320, and its H/D target updates, :426-493): h 0 the H transition
// and cell c's update of the H target were it its predecessor, h 1 the D
// transition and the D target's; both the R emission.  One code path for
// either half (the operands are selected), so the two groups of a row
// run it without diverging.
struct Half {
  double look;             // log Skellam: H (h 0) or D (h 1) transition
  double lR;               // R emission from the carried count
  double r;                // dh ratio: rH (h 0) or rD (h 1)
  long long cnt, cnt2;     // h 0: the H target's D and R counts; h 1: the
                           // D target's H count (cnt2 unused)
};

RD_FN Half phase_a(const Lane& L, int h, const StepIn& s, const Params& P) {
  const RowConst& C = L.C;
  const long long bpos_i = s.bpos, bcnt_i = s.bcnt;
  Half o;
  // the Skellam transition; its gather goes out first
  long long sth_p = L.ri[SP + HAP], sth_c = L.ri[SC + HAP];
  long long std_p = L.ri[SP + DIP], std_c = L.ri[SC + DIP];
  bool use_ratio = L.dh != -RD_INF;
  long long h_cb = use_ratio ? std_c : sth_c;
  long long h_pos = use_ratio ? std_p : sth_p;
  long long h_ce = use_ratio ? sat_i64(L.dh * (double)bcnt_i) : bcnt_i;
  const long long cb = h ? std_c : h_cb, pos = h ? std_p : h_pos;
  long long k = h ? wsub(bcnt_i, std_c) : wsub(h_ce, h_cb);
  double lam = (double)cb * (double)wabs(wsub(bpos_i, pos - C.PSTEP))
               / P.read_len;
  SkArgs ar = skellam_args(k, lam);
  SkRec rec = skellam_load(ar, P.tab);
  // R target emission
  long long strc = L.ri[SC + REP];
  double lf_strc = RD_LDG(P.lf_small + clampi(strc, 0, P.n1 - 1));
  double lf_sd = RD_LDG(P.lf_small + clampi(strc - bcnt_i, 0, P.n1 - 1));
  double le = bcnt_i < strc
      ? lf_strc - s.lf_b - lf_sd + (double)bcnt_i * P.log_1m_pe_mean
            + (double)(strc - bcnt_i) * P.log_pe_mean
      : -RD_INF;
  o.lR = le > P.r_logp
      ? le
      : ((s.max_cc >= C.cov[REP] || s.max_cc >= strc) ? P.r_logp : le);
  // cell c as the H (h 0) or D (h 1) target's predecessor: the target's
  // count ecnt, its other count from the ratio (rH * ecnt, ecnt / rD)
  const long long e = s.ecnt;
  const double ef = (double)e;
  o.r = dh_ratio(h != 0, L.ri, L.rb, C.fwd, bpos_i, bcnt_i);
  const double q = h ? ef / o.r : o.r * ef;
  const long long fall = h
      ? (flag(L.rb, HASH) ? L.ri[SC + HAP] : maxi(floordiv2(e), e - C.covH))
      : (flag(L.rb, HASD) ? L.ri[SC + DIP] : e + C.covH);
  o.cnt = o.r != -RD_INF ? sat_i64(q) : fall;
  o.cnt2 = h ? 0 : sat_i64(P.dr_ratio * (double)o.cnt);
  o.look = skellam_value(ar, rec);
  return o;
}

// b ? x : y, field by field (a runtime choice between two structs would
// take their addresses and put them in local memory)
RD_FN Half pick_half(bool b, const Half& x, const Half& y) {
  Half o;
  o.look = b ? x.look : y.look;
  o.lR = b ? x.lR : y.lR;
  o.r = b ? x.r : y.r;
  o.cnt = b ? x.cnt : y.cnt;
  o.cnt2 = b ? x.cnt2 : y.cnt2;
  return o;
}

// lane c's row of the step's terms and its candidate updates from its two
// halves
RD_FN void join(const Half& h0, const Half& h1, double logpE, double dp,
                Row& w, Cand& q) {
  const double st4[4] = {logpE, h0.lR, h0.look, h1.look};
  const bool dead = dp == -RD_INF;
  RD_UNROLL
  for (int t = 0; t < 4; ++t) w.lp[t] = dead ? -RD_INF : st4[t];
  q.rH = h0.r;
  q.dH = h0.cnt;
  q.rH_cnt = h0.cnt2;
  q.rD = h1.r;
  q.hD = h1.cnt;
}

// (B1) _lane_step's special cases (class_rel.c:321-356) on lane c's row,
// given the row maxima mc[k] = max4(lp[k][.]) of the step: the has_inf
// poisoning, the all-underflow case, the exp-underflow cut and the
// denormal band flag; then sc[c][.] and the row's only_r terms
RD_FN RowB phase_b1(const Row& w, double dp, const double mc[4]) {
  // normalisation dropped (argmax-invariant); C special cases kept
  double mx = max4(mc[0], mc[1], mc[2], mc[3]);
  RowB o;
  o.has_inf = mx == RD_INF;
  const bool zero = mx < -745.13;   // C: psum == 0.0 (all exp underflow)
  o.band = false;
  RD_UNROLL
  for (int t = 0; t < 4; ++t) {
    double v = w.lp[t];
    if (o.has_inf) v = (v == RD_INF) ? RD_NAN : -RD_INF;
    if (zero) v = (t == ERR) ? LOG_QUARTER : -RD_INF;
    // exp-underflow cut (class_rel.c:321-336) + the denormal band flag
    if (v > -745.2 && v < -719.0) o.band = true;
    if (v < -745.13) v = -RD_INF;
    o.lp[t] = v;
  }
  // ---- only_r (class_rel.c:348-356), row c's part
  RD_UNROLL
  for (int t = 0; t < 4; ++t) o.sc[t] = dp + o.lp[t];
  int bt;
  double best = maxarg4(o.sc, &bt);
  o.rep_s = (best == -RD_INF) || (bt == REP);
  double srep = o.sc[REP];
  double soth = max4(o.sc[0], -RD_INF, o.sc[2], o.sc[3]);
  double d = fabs(srep - soth);
  if (srep == -RD_INF || soth == -RD_INF) d = RD_INF;
  o.m_or = isnan_(d) ? 1e-30 : d;
  return o;
}

// (B2) _lane_step's decisions (class_rel.c:348-397) for target c, from
// the row's gathered terms (every lane alike: only_r, the HH/DD coupling)
// and target c's column (max, argmax, margin).  The step margin is folded
// into this lane's running minimum with target c's column margin only;
// the row's minimum over its four lanes is the reference's (margins are
// never NaN, so the order of min_ does not matter).
RD_FN Dec phase_b2(int c, double dp, const RowB& w, const Gath& g,
                   double& mmin) {
  const double m_band = g.band ? 1e-30 : RD_INF;
  // ---- only_r (class_rel.c:348-356)
  const bool r0 = g.rep_s & 1u, r1 = g.rep_s & 2u, r2 = g.rep_s & 4u,
             r3 = g.rep_s & 8u;
  const bool only_r = r0 && r1 && r2 && r3;
  bool p1 = r0, p2 = p1 && r1, p3 = p2 && r2;
  double m_onlyr = min4(g.m_or[0], p1 ? g.m_or[1] : RD_INF,
                        p2 ? g.m_or[2] : RD_INF, p3 ? g.m_or[3] : RD_INF);

  // ---- HH/DD coupling (class_rel.c:383-386)
  int aH, aD;
  double vH = maxarg4(g.colH, &aH), vD = maxarg4(g.colD, &aD);
  int maxs_h = vH == -RD_INF ? NST : aH;
  int maxs_d = vD == -RD_INF ? NST : aD;
  bool couple = maxs_h == HAP && maxs_d == DIP;
  double m_coup = min_(bin_margin(g.colH, HAP), bin_margin(g.colD, DIP));
  double col[4];
  RD_UNROLL
  for (int k = 0; k < 4; ++k) col[k] = g.col[k];
  if (couple) {
    double mcoup = min_(g.lpHH, g.lpDD);
    if (c == HAP) col[HAP] = dp + mcoup;
    if (c == DIP) col[DIP] = dp + mcoup;
  }

  // ---- target c's best predecessor (class_rel.c:390-397)
  Dec d;
  int max_s;
  d.max_v = maxarg4(col, &max_s);
  d.dead = d.max_v == -RD_INF;
  d.sel = d.dead ? 0 : max_s;
  double tm = top2_margin(col);

  // guard: the only_r margin always counts; selection/coupling margins
  // only when the step selects; has_inf rows always flag
  double m_poison = w.has_inf ? 1e-30 : RD_INF;
  double step_margin = min_(min_(m_onlyr, min_(m_band, m_poison)),
                            only_r ? RD_INF : min_(m_coup, tm));
  mmin = min_(mmin, step_margin);
  d.only_r = only_r;
  d.bp = (signed char)(only_r ? c : (d.dead ? NST : max_s));
  return d;
}

// (C) _lane_step's update of cell L.c (class_rel.c:357-380, 398-513),
// from ``src``, the registers of its selected predecessor
RD_FN void phase_c(Lane& L, const Regs& src, const Dec& d, const StepIn& s,
                   const Params& P) {
  const RowConst& C = L.C;
  const int c = L.c;
  if (d.only_r) {
    // only_r overrides (class_rel.c:357-380): same-state copy; dp and
    // eff unchanged, dh cleared
    if (c == HAP && L.dp != -RD_INF) {
      L.ri[LDBH] = L.ri[LD];
      L.ri[LDBH + 1] = L.ri[LD + 1];
      L.ri[LH] = L.eff0;
      L.ri[LH + 1] = L.eff1;
      L.rb = with_flag(L.rb, EXDBH, flag(L.rb, EXD));
      L.rb |= (1u << EXH) | (1u << HASH);
    }
    if (c == DIP && L.dp != -RD_INF) {
      L.ri[LHBD] = L.ri[LH];
      L.ri[LHBD + 1] = L.ri[LH + 1];
      L.ri[LD] = L.eff0;
      L.ri[LD + 1] = L.eff1;
      L.rb = with_flag(L.rb, EXHBD, flag(L.rb, EXH));
      L.rb |= (1u << EXD) | (1u << HASD);
    }
    L.dh = -RD_INF;
    return;
  }

  // the selected predecessor's registers (rel_dev2._sel4)
  RD_UNROLL
  for (int k = 0; k < NI; ++k) L.ri[k] = src.ri[k];
  L.rb = src.rb;
  const long long epos_i = s.epos, ecnt_i = s.ecnt;
  const long long oe = epos_i - C.OFF;
  double r = -RD_INF;
  if (c == HAP || c == DIP) {
    // HAPLO (class_rel.c:426-459) and DIPLO (:460-493) targets: the
    // predecessor's candidate ratio and counts (cand)
    const bool diplo = c == DIP;
    r = diplo ? src.q.rD : src.q.rH;
    const long long curr_h = diplo ? src.q.hD : ecnt_i;
    const long long curr_d = diplo ? ecnt_i : src.q.dH;
    L.ri[SP + REP] = oe;
    L.ri[SP + HAP] = oe;
    L.ri[SP + DIP] = oe;
    L.ri[SC + REP] = diplo ? sat_i64(P.dr_ratio * (double)curr_d)
                           : src.q.rH_cnt;
    L.ri[SC + HAP] = curr_h;
    L.ri[SC + DIP] = curr_d;
  } else if (c == REP) {
    // REPEAT target st (class_rel.c:413-425)
    long long r_cnt = mini(ecnt_i, C.covR);
    bool keep_r = L.ri[SC + REP] < r_cnt;
    L.ri[SP + HAP] = oe;
    L.ri[SP + DIP] = oe;
    if (!keep_r) {
      L.ri[SP + REP] = oe;
      L.ri[SC + REP] = r_cnt;
    }
  }
  // H<D<R gate on the new counts
  bool gate = L.ri[SC + HAP] < L.ri[SC + DIP]
              && L.ri[SC + DIP] < L.ri[SC + REP];
  L.dp = (d.dead || !gate) ? -RD_INF : d.max_v;
  // path registers: extend with target c (order: read before write)
  if (c == DIP) {
    L.ri[LHBD] = L.ri[LH];
    L.ri[LHBD + 1] = L.ri[LH + 1];
    L.rb = with_flag(L.rb, EXHBD, flag(L.rb, EXH));
    L.ri[LD] = epos_i;
    L.ri[LD + 1] = ecnt_i;
    L.rb |= (1u << EXD) | (1u << HASD);
  }
  if (c == HAP) {
    L.ri[LDBH] = L.ri[LD];
    L.ri[LDBH + 1] = L.ri[LD + 1];
    L.rb = with_flag(L.rb, EXDBH, flag(L.rb, EXD));
    L.ri[LH] = epos_i;
    L.ri[LH + 1] = ecnt_i;
    L.rb |= (1u << EXH) | (1u << HASH);
  }
  L.dh = r;
  L.eff0 = epos_i;
  L.eff1 = ecnt_i;
}

// The traceback of row b (class_rel.c:606-613), serial, on one lane.
RD_FN void traceback(const Args& a, int b, long long m, const double dp[4],
                     const signed char* bp, const unsigned char* rpos) {
  const int M = a.max_m;
  int cur;
  maxarg4(dp, &cur);
  const long long last = m - 1 > 0 ? m - 1 : 0;
  signed char* asgn = a.asgn + (long long)b * M;
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

// The row's tails (rel_tail.cuh), after its traceback, on its eight
// lanes, lane j of the row taking columns j, j + 8, ... (mw, the warp's
// longest row, bounds every lane's trips; the planes loaded as the step
// loop loads them, ld_plane<PRO>): on the first pass the rescue
// predicate over the columns within m, its sums reduced over the row's
// lanes, so that every lane takes the row's decision; then the packed row
// of a row this launch does not rescue (the rescue pass: every row it
// runs, with the min of both passes' margins).  The assignments are read
// with plain loads after warp_sync, which orders the traceback lane's
// stores before them: this launch wrote them, and the non-coherent path
// (RD_LDG) may return stale bytes.
template <int NL, bool PRO>
RD_FN void row_tails(const Args& a, const Lane (&L)[NL], const int (&wl)[NL],
                     const double (&mmv)[NL], int mw) {
  const int M = a.max_m;
  gl::RescueSums s[NL];
  bool res[NL];
  for (int l = 0; l < NL; ++l) {
    s[l] = gl::rescue_start(M);
    res[l] = false;
  }
  warp_sync();   // the traceback's assignment stores
  if (a.rescue) {
    for (int c0 = 0; c0 < mw; c0 += RESCUE_BATCH * LANES)
      for (int l = 0; l < NL; ++l) {
        const Lane& x = L[l];
        const long long row = (long long)x.row * M;
        int v[RESCUE_BATCH];
        long long bp[RESCUE_BATCH], bc[RESCUE_BATCH], ep[RESCUE_BATCH],
            ec[RESCUE_BATCH];
        RD_UNROLL
        for (int t = 0; t < RESCUE_BATCH; ++t) {
          const int c = c0 + t * LANES + (wl[l] & (LANES - 1));
          const long long i = row + (c < M ? c : M - 1);
          v[t] = a.asgn[i];
          bp[t] = ld_plane<PRO>(a.bpos + i);
          bc[t] = ld_plane<PRO>(a.bcnt + i);
          ep[t] = ld_plane<PRO>(a.epos + i);
          ec[t] = ld_plane<PRO>(a.ecnt + i);
        }
        RD_UNROLL
        for (int t = 0; t < RESCUE_BATCH; ++t) {
          const int c = c0 + t * LANES + (wl[l] & (LANES - 1));
          if (x.valid && c < x.m && c < M)
            gl::rescue_cell(s[l], v[t], c, bp[t], bc[t], ep[t], ec[t]);
        }
      }
    RD_UNROLL
    for (int off = LANES / 2; off > 0; off >>= 1) {
      long long v[4][NL], o[4][NL];
      for (int l = 0; l < NL; ++l) {
        v[0][l] = s[l].lsum;
        v[1][l] = s[l].csum;
        v[2][l] = s[l].nh;
        v[3][l] = s[l].key;
      }
      RD_UNROLL
      for (int k = 0; k < 4; ++k) from_xor<NL>(v[k], wl, off, o[k]);
      for (int l = 0; l < NL; ++l) {
        s[l].lsum = gl::wadd(s[l].lsum, o[0][l]);
        s[l].csum = gl::wadd(s[l].csum, o[1][l]);
        s[l].nh = gl::wadd(s[l].nh, o[2][l]);
        s[l].key = mini(s[l].key, o[3][l]);
      }
    }
    for (int l = 0; l < NL; ++l) {
      const Lane& x = L[l];
      if (!x.valid) continue;
      long long cv[4];
      res[l] = gl::rescue_decide(s[l], a.gcov, M, cv);
      if ((wl[l] & (LANES - 1)) != 0) continue;
      a.rescue[x.row] = res[l] ? 1 : 0;
      RD_UNROLL
      for (int k = 0; k < 4; ++k) a.cov2[4LL * x.row + k] = cv[k];
    }
  }
  if (!a.packed) return;
  // a warp none of whose rows packs (the rescue pass's rows not rescued)
  // skips the pack loop
  int packs[NL];
  for (int l = 0; l < NL; ++l) packs[l] = L[l].valid && !res[l];
  if (!warp_max(packs)) return;
  for (int c0 = 0; c0 < M; c0 += PACK_BATCH * LANES)
    for (int l = 0; l < NL; ++l) {
      const Lane& x = L[l];
      signed char v[PACK_BATCH];
      RD_UNROLL
      for (int t = 0; t < PACK_BATCH; ++t) {
        const int c = c0 + t * LANES + (wl[l] & (LANES - 1));
        v[t] = a.asgn[(long long)x.row * M + (c < M ? c : M - 1)];
      }
      RD_UNROLL
      for (int t = 0; t < PACK_BATCH; ++t) {
        const int c = c0 + t * LANES + (wl[l] & (LANES - 1));
        if (x.valid && !res[l] && c < M)
          a.packed[(long long)x.row * (M + 5) + c] = (unsigned char)v[t];
      }
    }
  for (int l = 0; l < NL; ++l) {
    const Lane& x = L[l];
    const int j = wl[l] & (LANES - 1);
    if (!x.valid || res[l] || j >= 5) continue;
    a.packed[(long long)x.row * (M + 5) + M + j] =
        gl::row_tail_byte(j, a.mm_prev, x.row, mmv[l]);
  }
}

// Lanes g0 .. g0+NL-1 of the launch (lane g: cell g % 4 of row g / 4).
// NL lanes run in this thread: 1 on the card (the thread's own lane), a
// whole warp of 32 in the host shim (g0 a multiple of 32), phase by phase
// with the exchanges between.  PRO: the launch writes its planes from
// a.blob first (prologue) and loads them with plain loads; else they come
// from another launch, through the read-only path.
template <int NL, bool PRO>
RD_FN void warp_rows(const Args& a, int g0, const Scratch& scr) {
  const int M = a.max_m;
  if constexpr (PRO) {
    prologue<NL>(a, g0);
    warp_sync();   // the prologue's plane stores before every load below
  }
  Lane L[NL];
  int wl[NL], mrow[NL];
  StepIn nxt[NL];
  for (int l = 0; l < NL; ++l) {
    Lane& x = L[l];
    const int g = g0 + l, b = g / LANES;
    x.c = g % CELLS;
    x.h = (g / CELLS) % 2;
    wl[l] = g % WARP;
    x.valid = b < a.R2 && !(a.active && !a.active[b]);
    x.row = b < a.R2 ? b : a.R2 - 1;
    const long long* cv = a.cov + (long long)x.row * 4;
    RD_UNROLL
    for (int k = 0; k < 4; ++k) x.C.cov[k] = cv[k];
    x.C.fwd = a.fwd[x.row] != 0;
    x.C.OFF = x.C.fwd ? a.P.offset : -a.P.offset;
    x.C.PSTEP = x.C.fwd ? 1 : -1;
    x.C.covR = x.C.cov[REP];
    x.C.covH = x.C.cov[HAP];
    x.m = a.m[x.row];
    init_lane(x, a.plen[x.row], load_step<PRO>(a, x.row, 0), a.P);
    mrow[l] = x.valid ? (int)x.m : 0;
    if (x.valid && x.c == 0 && x.h == 0)
      scr.rpos[(long long)(b - scr.row0) * M] = 0;
  }
  // the longest row of the warp: every lane steps until it ends
  const int mw = warp_max(mrow);
  for (int l = 0; l < NL; ++l)
    if (1 < mw) nxt[l] = load_step<PRO>(a, L[l].row, 1);

  // phase clocks (warp_lanes.cuh), parts: A, exchange 1, B1, exchange 2,
  // B2, exchange 3, C
  RD_CLOCKS;
  for (int i = 1; i < mw; ++i) {
    RD_MARK(0);
    StepIn s[NL];
    bool live[NL];
    Row w[NL];
    Cand cq[NL];
    double mc[NL];
    Half own[NL], oth[NL];
    for (int l = 0; l < NL; ++l) {
      // this step's plane values were loaded one step ahead
      s[l] = nxt[l];
      if (i + 1 < mw) nxt[l] = load_step<PRO>(a, L[l].row, i + 1);
      live[l] = L[l].valid && i < L[l].m;
      own[l] = Half{0.0, 0.0, 0.0, 0, 0};
      if (live[l]) own[l] = phase_a(L[l], L[l].h, s[l], a.P);
    }
    {
      // exchange 0: the other group's half of the row's terms
      int src[NL];
      double v[NL], out[NL];
      long long u[NL], uo[NL];
      for (int l = 0; l < NL; ++l) {
        src[l] = wl[l] ^ CELLS;
        oth[l].lR = own[l].lR;   // both groups compute the R emission
      }
      for (int l = 0; l < NL; ++l) v[l] = own[l].look;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) oth[l].look = out[l];
      for (int l = 0; l < NL; ++l) v[l] = own[l].r;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) oth[l].r = out[l];
      for (int l = 0; l < NL; ++l) u[l] = own[l].cnt;
      xchg<NL>(u, src, uo);
      for (int l = 0; l < NL; ++l) oth[l].cnt = uo[l];
      for (int l = 0; l < NL; ++l) u[l] = own[l].cnt2;
      xchg<NL>(u, src, uo);
      for (int l = 0; l < NL; ++l) oth[l].cnt2 = uo[l];
    }
    for (int l = 0; l < NL; ++l) {
      const bool h1 = L[l].h == 1;
      join(pick_half(h1, oth[l], own[l]), pick_half(h1, own[l], oth[l]),
           s[l].logpE, L[l].dp, w[l], cq[l]);
      mc[l] = max4(w[l].lp[0], w[l].lp[1], w[l].lp[2], w[l].lp[3]);
    }
    RD_MARK(1);
    // exchange 1: the row maxima
    double mcs[NL][4];
    gather4<CELLS>(mc, wl, mcs);
    RD_MARK(2);
    RowB rb[NL];
    double m_or[NL], scH[NL], scD[NL], lpH[NL], lpD[NL], sc[NL][4];
    bool rep_s[NL], band[NL];
    for (int l = 0; l < NL; ++l) {
      rb[l] = phase_b1(w[l], L[l].dp, mcs[l]);
      m_or[l] = rb[l].m_or;
      scH[l] = rb[l].sc[HAP];
      scD[l] = rb[l].sc[DIP];
      lpH[l] = rb[l].lp[HAP];
      lpD[l] = rb[l].lp[DIP];
      rep_s[l] = rb[l].rep_s;
      band[l] = rb[l].band;
      RD_UNROLL
      for (int t = 0; t < 4; ++t) sc[l][t] = rb[l].sc[t];
    }
    RD_MARK(3);
    // exchange 2: the row's only_r terms, the H and D columns, the two
    // coupled terms, and this lane's target column
    Gath gx[NL];
    {
      double t4[NL][4], t1[NL];
      unsigned bits[NL];
      gather4<CELLS>(m_or, wl, t4);
      for (int l = 0; l < NL; ++l)
        for (int k = 0; k < 4; ++k) gx[l].m_or[k] = t4[l][k];
      gather4<CELLS>(scH, wl, t4);
      for (int l = 0; l < NL; ++l)
        for (int k = 0; k < 4; ++k) gx[l].colH[k] = t4[l][k];
      gather4<CELLS>(scD, wl, t4);
      for (int l = 0; l < NL; ++l)
        for (int k = 0; k < 4; ++k) gx[l].colD[k] = t4[l][k];
      from_lane<CELLS>(lpH, wl, HAP, t1);
      for (int l = 0; l < NL; ++l) gx[l].lpHH = t1[l];
      from_lane<CELLS>(lpD, wl, DIP, t1);
      for (int l = 0; l < NL; ++l) gx[l].lpDD = t1[l];
      transpose4<NL>(sc, wl, t4);
      for (int l = 0; l < NL; ++l)
        for (int k = 0; k < 4; ++k) gx[l].col[k] = t4[l][k];
      row_bits<CELLS>(rep_s, wl, bits);
      for (int l = 0; l < NL; ++l) gx[l].rep_s = bits[l];
      row_bits<CELLS>(band, wl, bits);
      for (int l = 0; l < NL; ++l) gx[l].band = bits[l];
    }
    RD_MARK(4);
    Dec d[NL];
    int src[NL];
    for (int l = 0; l < NL; ++l) {
      d[l] = Dec{false, false, 0, 0.0, 0};
      if (live[l]) {
        d[l] = phase_b2(L[l].c, L[l].dp, rb[l], gx[l], L[l].mmin);
        const long long r = L[l].row - scr.row0;
        if (L[l].h == 0) {
          scr.bp[(r * (M - 1) + (i - 1)) * 4 + L[l].c] = d[l].bp;
          if (L[l].c == 0) scr.rpos[r * M + i] = d[l].only_r ? 1 : 0;
        }
      }
      src[l] = (wl[l] & ~(CELLS - 1)) + d[l].sel;
    }
    RD_MARK(5);
    // exchange 3: lane c takes the registers and candidate updates of
    // lane sel[c] of its row
    Regs in[NL];
    RD_UNROLL
    for (int k = 0; k < NI; ++k) {
      long long v[NL], out[NL];
      for (int l = 0; l < NL; ++l) v[l] = L[l].ri[k];
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].ri[k] = out[l];
    }
    {
      unsigned v[NL], out[NL];
      for (int l = 0; l < NL; ++l) v[l] = L[l].rb;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].rb = out[l];
    }
    {
      double v[NL], out[NL];
      for (int l = 0; l < NL; ++l) v[l] = cq[l].rH;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].q.rH = out[l];
      for (int l = 0; l < NL; ++l) v[l] = cq[l].rD;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].q.rD = out[l];
    }
    {
      long long v[NL], out[NL];
      for (int l = 0; l < NL; ++l) v[l] = cq[l].dH;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].q.dH = out[l];
      for (int l = 0; l < NL; ++l) v[l] = cq[l].rH_cnt;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].q.rH_cnt = out[l];
      for (int l = 0; l < NL; ++l) v[l] = cq[l].hD;
      xchg<NL>(v, src, out);
      for (int l = 0; l < NL; ++l) in[l].q.hD = out[l];
    }
    RD_MARK(6);
    for (int l = 0; l < NL; ++l)
      if (live[l]) phase_c(L[l], in[l], d[l], s[l], a.P);
    RD_MARK(7);
    RD_ADD_STEP;
  }
  RD_FLUSH(L[0].valid && L[0].c == 0 && L[0].h == 0, mw > 1 ? mw - 1 : 0);

  // the row's final cell and running margins, and its margin, on every
  // lane of the row
  double dp[NL], mm[NL], dpa[NL][4], mma[NL][4], mmv[NL];
  for (int l = 0; l < NL; ++l) {
    dp[l] = L[l].dp;
    mm[l] = L[l].mmin;
  }
  gather4<CELLS>(dp, wl, dpa);
  gather4<CELLS>(mm, wl, mma);
  for (int l = 0; l < NL; ++l) {
    // row margin: min FIRST, then the all-dead force flag (an exact-tie
    // step margin of 0.0 must not mask it)
    mmv[l] = min_(min4(mma[l][0], mma[l][1], mma[l][2], mma[l][3]),
                  top2_margin(dpa[l]));
    if (dpa[l][0] == -RD_INF && dpa[l][1] == -RD_INF
        && dpa[l][2] == -RD_INF && dpa[l][3] == -RD_INF)
      mmv[l] = 1e-30;
  }
  warp_sync();   // the row's backpointers, written by its 4 lanes
  for (int l = 0; l < NL; ++l) {
    const Lane& x = L[l];
    if (!x.valid || x.h != 0) continue;
    const int b = x.row;
    a.dp_out[(long long)b * 4 + x.c] = x.dp;
    if (x.c != 0) continue;
    a.mm_out[b] = mmv[l];
    const long long r = b - scr.row0;
    traceback(a, b, x.m, dpa[l], scr.bp + r * (M - 1) * 4,
              scr.rpos + r * M);
  }
  if (a.rescue || a.packed) row_tails<NL, PRO>(a, L, wl, mmv, mw);
}

}  // namespace rd
