// The two relaxation sweeps for one warp of read rows, four lanes per row:
// the descending sweep, then the ascending one, each step re-deciding one
// unreliable interval from its nearest reliable H/D neighbours.  Shared by
// the CUDA kernel (unrel.cu, nvcc: one thread is one lane) and the host
// test shim (the same file under g++ -x c++: one call runs a warp's 32
// lanes, phase by phase), so the CPU tests exercise the arithmetic, the
// lane exchanges and the bitmask search the card runs.
//
// Replaces the JAX package's unrel_dev2.unrel_sweeps2 (unrel_dev2.py:67)
// with _unrel_lane's step_fn (:157-279), class_unrel.c:248-300.  Semantics
// follow the JAX code line for line; classpro_tpu_torch/unrel_ref.py is
// the plain torch version.  The log-Skellam lookup is rd::skellam, the
// same function the DP kernel (rel_dp_row.cuh) inlines (rd_math.cuh).
//
// A row's working state lives in its RowMem (the block's shared memory,
// or a global scratch for rows too long for it): in shared memory a copy
// of its packL / packR records; its active steps' intervals in step
// order, compacted once; the working assignment w; and
// two bitmasks over its columns, H (bit c: is_rel[c], c < min(n, N) and
// w[c] == H) and D (the same with D), each with a summary word per 1024
// columns (bit k: mask word k is not 0).  Lane j of the row's group owns
// slot j of the step, [H-left, H-right, D-left, D-right]:
//   (S) its nearest neighbour: the highest set bit below idx (left slots)
//       or the lowest above it (right slots) in its state's mask, by the
//       word's bit scan, else the summary's, else one summary word per
//       1024 columns further (one instruction stream for both
//       directions); then the neighbour's record (packL / packR);
//   exchange A (lane j ^ 1, the other side of the same state): its record;
//   (I) slot j's Skellam table gather (its record is all it needs), then,
//       under it, slot j's coverage interpolation (one division), and on
//       lanes 2, 3 the log-factorial gathers of side j - 2's R-binomial
//       term;
//   exchange B (lane j ^ 2, the other state on the same side): the
//       cross-state fallback of the estimated coverage;
//   (K) slot j's binomial-tail gather, the Skellam value and (lanes 2, 3)
//       the R-binomial term;
//   exchange C (lane j ^ 1): its lookup, tail and R-binomial term;
//   (H) lanes 0 and 2: state j / 2's side combination; lane 2 also the R
//       candidate;
//   exchange D (lane 2 to the group): the D and R candidates;
//   (D) lane 0: argmax and margin, w[idx] and the two masks' bit idx.
// The step's 13-plane record is loaded one active step ahead (and first
// used then: a use at the load would wait for it).  Lanes whose
// row has no step left (or lies past B) stay in the loop, predicated,
// until the warp's longest row ends: every exchange has all 32 lanes.
// The running minimum margin is lane 0's, taken in step order.
//
// Numerics (built with --fmad=false / -ffp-contract=off, never fast
// math): every expression keeps the JAX code's operation order; maxima
// propagate NaN; the argmax takes the first NaN, else the first maximum
// (jnp.argmax); the margin is rd::top2_margin; float -> int64 casts
// saturate (NaN -> 0) and only the taken branch's value is used; int64
// arithmetic wraps; _div_cr is plain IEEE division.  Values read from the
// planes gain +0.0, as the JAX code's one-hot sums do.

#pragma once

#include "rd_math.cuh"
#include "warp_lanes.cuh"

namespace ur {

using rd::DIP;
using rd::HAP;
using rd::REP;

constexpr int G = 4;                            // lanes per read row
constexpr int ROWS_PER_WARP = rd::WARP / G;

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
  signed char* asgn;             // out (B, N)
  double* mm_out;                // out (B,)
  unsigned char* scratch;        // (B, row_bytes) when not in shared memory
  int B, N;
  Params P;
};

// A row's working state: with ``packs`` its packL and packR records (3
// f64 each per interval), then 2N int32 step intervals, the H and D masks
// (W words each) and their summaries (S words each), w (N int8).
struct Layout {
  int N, W, S;
  bool packs;
  long long steps, masks, w, row_bytes;   // byte offsets in the row
};

RD_FN Layout layout(int N, bool packs) {
  Layout L;
  L.N = N;
  L.W = (N + 31) / 32;
  L.S = (L.W + 31) / 32;
  L.packs = packs;
  L.steps = packs ? 48LL * N : 0;
  L.masks = L.steps + 8LL * N;
  L.w = L.masks + 8LL * (L.W + L.S);
  L.row_bytes = (L.w + N + 15) / 16 * 16;
  return L;
}

struct RowMem {
  const double *pL, *pR;   // the row's packL / packR records
  int* steps;
  unsigned *Hm, *Dm, *Hs, *Ds;
  signed char* w;
};

// Row b's state at ``base``; without a copy of its records there, they
// are read from the inputs.
RD_FN RowMem row_mem(unsigned char* base, const Layout& L, const Args& a,
                     long long o) {
  RowMem m;
  m.pL = L.packs ? (const double*)base : a.packL + o * 3;
  m.pR = L.packs ? (const double*)base + 3LL * L.N : a.packR + o * 3;
  m.steps = (int*)(base + L.steps);
  unsigned* u = (unsigned*)(base + L.masks);
  m.Hm = u;
  m.Dm = u + L.W;
  m.Hs = u + 2 * L.W;
  m.Ds = u + 2 * L.W + L.S;
  m.w = (signed char*)(base + L.w);
  return m;
}

// Where a warp keeps its rows: row b at base + (b - row0) * row_bytes;
// ``packs``: with a copy of their records.
struct Scratch {
  unsigned char* base;
  int row0;
  bool packs;
};

// The nearest set bit of a mask below column i (up false) or above it (up
// true), -1 if none; 0 <= i < N, nS summary words.  One instruction
// stream for both directions (a warp's lanes search both at once): a word
// is bit-reversed for the upward search, so that the nearest bit is its
// highest in either direction.
RD_FN int nearest(const unsigned* m, const unsigned* s, int nS, int i,
                  bool up) {
  const int k = i >> 5, b = i & 31;
  // the bits strictly beyond column i (below it, or above it) of word k
  const unsigned lo = (1u << b) - 1u, hi = b == 31 ? 0u : ~0u << (b + 1);
  const unsigned x = m[k] & (up ? hi : lo);
  if (x) {
    const int t = rd::top_bit(up ? rd::brev32(x) : x);
    return (k << 5) + (up ? 31 - t : t);
  }
  // the nearest non-zero word beyond k, by the summaries
  int q = k >> 5;
  const int kb = k & 31;
  const unsigned slo = (1u << kb) - 1u, shi = kb == 31 ? 0u : ~0u << (kb + 1);
  unsigned y = s[q] & (up ? shi : slo);
  while (!y && (up ? q + 1 < nS : q > 0)) y = s[up ? ++q : --q];
  if (!y) return -1;
  const int ty = rd::top_bit(up ? rd::brev32(y) : y);
  const int kk = (q << 5) + (up ? 31 - ty : ty);
  const unsigned z = m[kk];
  const int tz = rd::top_bit(up ? rd::brev32(z) : z);
  return (kk << 5) + (up ? 31 - tz : tz);
}

// bit c of a mask := on, and its word's summary bit
RD_FN void set_bit(unsigned* m, unsigned* s, int c, bool on) {
  const int k = c >> 5;
  const unsigned bit = 1u << (c & 31);
  const unsigned x = on ? (m[k] | bit) : (m[k] & ~bit);
  m[k] = x;
  const unsigned sb = 1u << (k & 31);
  s[k >> 5] = x ? (s[k >> 5] | sb) : (s[k >> 5] & ~sb);
}

// jnp.argmax over 4: the first NaN, else the first maximum
RD_FN int argmax4(const double x[4]) {
  RD_UNROLL
  for (int k = 0; k < 4; ++k)
    if (rd::isnan_(x[k])) return k;
  int i;
  rd::maxarg4(x, &i);
  return i;
}

RD_FN double lf_at(const Params& P, long long i) {
  return RD_LDG(P.lf_small + rd::clampi(i, 0, P.n1 - 1));
}

// One active step's inputs: its interval, is_rel there, the 13 planes.
// load_step only issues the loads (a step ahead); ready() is their first
// use, a step later, with the +0.0 of the plane reads.
struct StepIn {
  int idx;
  unsigned char rel;
  double v[NP];
};

RD_FN StepIn load_step(const Args& a, long long o, int idx) {
  StepIn s;
  s.idx = idx;
  s.rel = a.is_rel[o + idx];
  RD_UNROLL
  for (int k = 0; k < NP; ++k) s.v[k] = RD_LDG(a.P13 + (o + idx) * NP + k);
  return s;
}

RD_FN StepIn ready(const StepIn& n) {
  StepIn s = n;
  RD_UNROLL
  for (int k = 0; k < NP; ++k) s.v[k] = n.v[k] + 0.0;
  return s;
}

// One lane: slot j of row b.
struct Lane {
  int j;
  int b;
  bool valid;              // b < B
  long long o, nrow;
  int lim, cnt;            // min(n, N); the row's active steps
  RowMem m;
  double mm;               // the running margin (lane 0 of the row)
};

// an active step: live, its interval in [0, N), and not a reliable
// interval fixed at H/D in asgn0 (those are never re-decided)
RD_FN bool active_step(const Args& a, const Lane& L, const int* xs, int t,
                       int* idx) {
  if (!a.live[L.o + t]) return false;
  const int i = xs[L.o + t];
  *idx = i;
  if (i < 0 || i >= a.N) return false;
  const int s0 = a.asgn0[L.o + i];
  return !(a.is_rel[L.o + i] && i < L.nrow && (s0 == HAP || s0 == DIP));
}

// Lanes g0 .. g0+NL-1 of the launch (lane g: slot g % 4 of row g / 4).
// NL lanes run in this thread: 1 on the card, a whole warp of 32 in the
// host shim (g0 a multiple of 32), phase by phase with the exchanges
// between.
template <int NL>
RD_FN void warp_rows(const Args& a, int g0, const Scratch& scr) {
  const Params& P = a.P;
  const int N = a.N;
  const Layout Y = layout(N, scr.packs);
  const double NINF = -RD_INF;
  Lane L[NL];
  int wl[NL];
  for (int l = 0; l < NL; ++l) {
    Lane& x = L[l];
    const int g = g0 + l;
    x.j = g % G;
    x.b = g / G;
    wl[l] = g % rd::WARP;
    x.valid = x.b < a.B;
    x.o = (long long)x.b * N;
    x.nrow = x.valid ? a.n[x.b] : 0;
    x.lim = (int)(x.nrow < N ? x.nrow : N);
    x.cnt = 0;
    x.mm = RD_INF;
    x.m = row_mem(scr.base + (long long)(x.b - scr.row0) * Y.row_bytes, Y,
                  a, x.o);
  }
  // ---- the row's state: its records (lane j: intervals j, j+G, ..), w
  // and the mask words (lane j: words j, j+G, ..), then the summaries
  for (int l = 0; l < NL; ++l) {
    const Lane& x = L[l];
    if (!x.valid) continue;
    if (Y.packs) {
      for (int c = x.j; c < N; c += G) {
        RD_UNROLL
        for (int k = 0; k < 3; ++k) {
          ((double*)x.m.pL)[3 * c + k] = RD_LDG(a.packL + (x.o + c) * 3 + k);
          ((double*)x.m.pR)[3 * c + k] = RD_LDG(a.packR + (x.o + c) * 3 + k);
        }
      }
    }
    for (int k = x.j; k < Y.W; k += G) {
      unsigned h = 0, d = 0;
      for (int i = 0; i < 32 && (k << 5) + i < N; ++i) {
        const int c = (k << 5) + i;
        const int v = a.asgn0[x.o + c];
        x.m.w[c] = (signed char)v;
        const bool rel = c < x.lim && a.is_rel[x.o + c];
        h |= (rel && v == HAP ? 1u : 0u) << i;
        d |= (rel && v == DIP ? 1u : 0u) << i;
      }
      x.m.Hm[k] = h;
      x.m.Dm[k] = d;
    }
  }
  rd::warp_sync();
  for (int l = 0; l < NL; ++l) {
    const Lane& x = L[l];
    if (!x.valid) continue;
    for (int q = x.j; q < Y.S; q += G) {
      unsigned hs = 0, ds = 0;
      for (int i = 0; i < 32 && (q << 5) + i < Y.W; ++i) {
        hs |= (x.m.Hm[(q << 5) + i] ? 1u : 0u) << i;
        ds |= (x.m.Dm[(q << 5) + i] ? 1u : 0u) << i;
      }
      x.m.Hs[q] = hs;
      x.m.Ds[q] = ds;
    }
  }
  // ---- the active steps of both sweeps, compacted in step order: lane j
  // takes steps t0 + j, the group's ballot places them
  for (int sweep = 0; sweep < 2; ++sweep) {
    const int* xs = sweep == 0 ? a.idx_desc : a.idx_asc;
    for (int t0 = 0; t0 < N; t0 += G) {
      bool act[NL];
      int idx[NL];
      unsigned bits[NL];
      for (int l = 0; l < NL; ++l) {
        const int t = t0 + L[l].j;
        act[l] = L[l].valid && t < N && active_step(a, L[l], xs, t, &idx[l]);
      }
      rd::row_bits<G>(act, wl, bits);
      for (int l = 0; l < NL; ++l) {
        Lane& x = L[l];
        if (act[l])
          x.m.steps[x.cnt + rd::popc32(bits[l] & ((1u << x.j) - 1u))] = idx[l];
        x.cnt += rd::popc32(bits[l]);
      }
    }
  }
  rd::warp_sync();
  int cnt[NL];
  for (int l = 0; l < NL; ++l) cnt[l] = L[l].cnt;
  const int mw = rd::warp_max(cnt);

  // Every lane loads a next record each step, a row without one the
  // first interval of row 0 (the loads stay unconditional: a conditional
  // one is a select that waits for them)
  StepIn nx[NL];
  if (mw > 0)
    for (int l = 0; l < NL; ++l) {
      const bool any = L[l].cnt > 0;
      nx[l] = load_step(a, any ? L[l].o : 0, any ? L[l].m.steps[0] : 0);
    }
  // phase clocks (warp_lanes.cuh), parts: S, exchange A, I, exchange B, K,
  // exchanges C + H + exchange D, D
  RD_CLOCKS;
  for (int it = 0; it < mw; ++it) {
    RD_MARK(0);
    StepIn s[NL];
    bool live[NL];
    int ok[NL], nb[NL], na[NL];
    double V0[NL], V1[NL], V2[NL];
    // ---- (S) slot j's nearest neighbour and its record
    for (int l = 0; l < NL; ++l) {
      const Lane& x = L[l];
      live[l] = it < x.cnt;
      ok[l] = 0;
      V0[l] = V1[l] = V2[l] = 0.0;
      nb[l] = na[l] = 0;
      s[l] = ready(nx[l]);
      const bool more = it + 1 < x.cnt;
      nx[l] = load_step(a, more ? x.o : 0, more ? x.m.steps[it + 1] : 0);
      if (!live[l]) continue;
      const int idx = s[l].idx;
      const bool Hst = x.j < 2;
      const unsigned* mk = Hst ? x.m.Hm : x.m.Dm;
      const unsigned* sm = Hst ? x.m.Hs : x.m.Ds;
      const int J = nearest(mk, sm, Y.S, idx, x.j & 1);
      if (J >= 0) {
        const double* pk = ((x.j & 1) ? x.m.pR : x.m.pL) + 3LL * J;
        ok[l] = 1;
        V0[l] = pk[0] + 0.0;
        V1[l] = pk[1] + 0.0;
        V2[l] = pk[2] + 0.0;
      }
      nb[l] = idx - 1 >= 0 ? x.m.w[idx - 1] : 0;
      na[l] = idx + 1 < N ? x.m.w[idx + 1] : 0;
    }
    RD_MARK(1);
    // ---- exchange A: the other side of this state
    int pok[NL];
    double pV0[NL], pV1[NL], pV2[NL];
    rd::from_xor(ok, wl, 1, pok);
    rd::from_xor(V0, wl, 1, pV0);
    rd::from_xor(V1, wl, 1, pV1);
    rd::from_xor(V2, wl, 1, pV2);
    RD_MARK(2);
    // ---- (I) est_cov of slot j (class_unrel.c:27-43); lanes 2, 3: the
    // R-binomial term of side j - 2 (logp_r_u, class_unrel.c:67-113)
    long long val[NL], icb[NL], ice[NL], kb[NL], db[NL];
    int found[NL], over[NL];
    double lfr[NL], lfd[NL];
    rd::SkArgs ska[NL];
    rd::SkRec skr[NL];
    for (int l = 0; l < NL; ++l) {
      const Lane& x = L[l];
      val[l] = 0;
      found[l] = over[l] = 0;
      lfr[l] = lfd[l] = 0.0;
      icb[l] = ice[l] = kb[l] = db[l] = 0;
      if (!live[l]) continue;
      const double* v = s[l].v;
      icb[l] = rd::sat_i64(v[CB]);
      ice[l] = rd::sat_i64(v[CE]);
      const bool right = x.j & 1;
      const double xq = right ? v[XR] : v[XL];
      // the Skellam drift to slot j's neighbour needs only its own record:
      // its table gather goes out first, the rest of the step under it
      long long kk = rd::wsub(right ? ice[l] : icb[l], rd::sat_i64(V0[l]));
      if (right) kk = rd::wsub(0, kk);
      ska[l] = rd::skellam_args(kk, V0[l] * fabs(xq - V1[l]) / P.read_len);
      skr[l] = rd::skellam_load(ska[l], P.tab);
      const bool l_ok = right ? pok[l] : ok[l], r_ok = right ? ok[l] : pok[l];
      const double Lc = right ? pV0[l] : V0[l], Le = right ? pV1[l] : V1[l];
      const double Rc = right ? V0[l] : pV0[l], Rb = right ? V1[l] : pV1[l];
      if (l_ok && r_ok)
        val[l] = rd::sat_i64(Lc + ((Rc - Lc) * (xq - Le)) / (Rb - Le));
      else
        val[l] = l_ok ? rd::sat_i64(Lc) : (r_ok ? rd::sat_i64(Rc) : 0);
      found[l] = l_ok || r_ok;
      if (x.j >= 2) {
        // dl (lane 2) / dr (lane 3): uncorrected neighbour counts
        const double dn = ok[l] ? V2[l] : (pok[l] ? pV2[l] : (double)P.cov_d);
        const long long rl = rd::sat_i64(P.dr_ratio * dn);
        kb[l] = right ? ice[l] : icb[l];
        db[l] = rd::wsub(rl, kb[l]);
        lfr[l] = lf_at(P, rl);   // gathers; the term is summed in (K)
        lfd[l] = lf_at(P, db[l]);
        over[l] = kb[l] >= rl;
      }
    }
    RD_MARK(3);
    // ---- exchange B: the other state on this side
    long long oval[NL];
    int ofound[NL];
    rd::from_xor(val, wl, 2, oval);
    rd::from_xor(found, wl, 2, ofound);
    RD_MARK(4);
    // ---- (K) the tail at the estimated coverage; the Skellam value
    double sk[NL], sfe[NL], bi[NL];
    for (int l = 0; l < NL; ++l) {
      const Lane& x = L[l];
      sk[l] = sfe[l] = bi[l] = 0.0;
      if (!live[l]) continue;
      const bool Hst = x.j < 2;
      long long estf;
      if (found[l])
        estf = val[l];
      else if (ofound[l] && oval[l] > 0)
        estf = Hst ? rd::floordiv2(oval[l]) : rd::wmul(oval[l], 2);
      else
        estf = Hst ? P.cov_h : P.cov_d;
      const long long cnt4 = (x.j & 1) ? ice[l] : icb[l];
      const long long nq = rd::clampi(estf, 1, P.n_cap - 1);
      const long long kq = rd::clampi(rd::wsub(estf, cnt4), 0, P.n_cap - 1);
      const double t = RD_LDG(P.btg_flat + (int)(nq * P.n_cap + kq));
      sk[l] = rd::skellam_value(ska[l], skr[l]);
      sfe[l] = estf >= cnt4 ? t : NINF;
      if (x.j >= 2)
        bi[l] = lfr[l] - ((x.j & 1) ? s[l].v[LFCE] : s[l].v[LFCB]) - lfd[l]
                + (double)kb[l] * P.log_1m_pe_mean
                + (double)db[l] * P.log_pe_mean;
    }
    RD_MARK(5);
    // ---- exchange C: the other side's lookup, tail and R-binomial term
    double psk[NL], psfe[NL], pbi[NL];
    int pover[NL];
    rd::from_xor(sk, wl, 1, psk);
    rd::from_xor(sfe, wl, 1, psfe);
    rd::from_xor(bi, wl, 1, pbi);
    rd::from_xor(over, wl, 1, pover);
    // ---- (H) lanes 0, 2: state j / 2's side combination
    // (class_unrel.c:115-183); lane 2: the R candidate
    double lhd[NL], lR[NL];
    for (int l = 0; l < NL; ++l) {
      const Lane& x = L[l];
      lhd[l] = lR[l] = 0.0;
      if (!live[l] || (x.j & 1)) continue;
      const double* v = s[l].v;
      const int idx = s[l].idx;
      const bool Hst = x.j == 0;
      const int S = Hst ? HAP : DIP;
      const double er_l = (idx - 1 >= 0 && nb[l] == S) ? v[PEOB] : NINF;
      const double er_r = ((long long)idx + 1 < x.nrow && na[l] == S)
                              ? v[PEOE] : NINF;
      const double sf_l = ok[l] ? sk[l] : NINF;
      const double sf_r = pok[l] ? psk[l] : NINF;
      const double logp_l = rd::max_(rd::max_(er_l, sf_l), sfe[l]);
      const double logp_r = rd::max_(rd::max_(er_r, sf_r), psfe[l]);
      const double po_b = Hst ? v[POHB] : v[PODB];
      const double po_e = Hst ? v[POHE] : v[PODE];
      const bool l_inf = logp_l == NINF, r_inf = logp_r == NINF;
      const bool both_inf = l_inf && r_inf;
      const double lpl = both_inf ? po_b : (l_inf ? logp_r : logp_l);
      const double lpr = both_inf ? po_e : (r_inf ? lpl : logp_r);
      lhd[l] = lpl + lpr;
      if (!Hst) {
        const double lp_r = bi[l] + pbi[l];
        const bool hi = rd::maxi(icb[l], ice[l]) >= P.cov_r;
        lR[l] = hi ? 0.0 : ((over[l] || pover[l]) ? P.r_logp : lp_r);
      }
    }
    // ---- exchange D: lane 2's D and R candidates to the group
    double lD[NL], lRr[NL];
    rd::from_lane<G>(lhd, wl, 2, lD);
    rd::from_lane<G>(lR, wl, 2, lRr);
    RD_MARK(6);
    // ---- (D) lane 0: the decision, the margin, the row's state
    for (int l = 0; l < NL; ++l) {
      Lane& x = L[l];
      if (!live[l] || x.j != 0) continue;
      const int idx = s[l].idx;
      const double cand[4] = {s[l].v[LE], lRr[l], lhd[l], lD[l]};
      const bool force_r = rd::maxi(icb[l], ice[l]) >= P.cov_r;
      const int st = force_r ? REP : argmax4(cand);
      // exactness-guard margin; a forced REPEAT is an exact int compare
      x.mm = rd::min_(x.mm, force_r ? RD_INF : rd::top2_margin(cand));
      x.m.w[idx] = (signed char)st;
      if (s[l].rel && idx < x.lim) {
        set_bit(x.m.Hm, x.m.Hs, idx, st == HAP);
        set_bit(x.m.Dm, x.m.Ds, idx, st == DIP);
      }
    }
    rd::warp_sync();
    RD_MARK(7);
    RD_ADD_STEP;
  }
  RD_FLUSH(L[0].valid && L[0].j == 0, mw);
  // ---- the row out: lane j writes columns j, j+G, ..; lane 0 the margin
  for (int l = 0; l < NL; ++l) {
    const Lane& x = L[l];
    if (!x.valid) continue;
    for (int c = x.j; c < N; c += G) a.asgn[x.o + c] = x.m.w[c];
    if (x.j == 0) a.mm_out[x.b] = x.mm;
  }
}

}  // namespace ur
