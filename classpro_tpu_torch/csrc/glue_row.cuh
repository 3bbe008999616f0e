// The per-chunk glue around the DP kernel (K4) and the sweep kernel (K6):
// the per-cell and per-row bodies of the four glue kernels of glue.cu.
// Shared by the CUDA kernels (nvcc: one thread is one lane) and the host
// test shim (the same file under g++ -x c++: one call runs a warp's 32
// lanes, phase by phase), so the CPU tests exercise the kernels' own
// arithmetic and lane reductions.
//
// Replaces, in the JAX package's device_pipeline.py:
//   prep_main_cell    _rel_only_core :572-626 (both scan directions from
//                     the forward-order blobs, the log-factorial lookups)
//                     and the E emission of _rel_pipeline :170-174;
//   prep_alldev_cell  _unpack :119 (the rel planes as int64), the E
//                     emission, _un_planes :511-538 and the sweeps'
//                     N_STATE assignment rows of classify_batch_dev :686;
//   rescue_warp       the no-H rescue predicate and cov2 (:198-234);
//   pack_warp         the pass merge (:237-241) and _pack_out :638-651;
//   settle_warp       the pass merge, _demotes_dev :257-294,
//                     _reconcile_dev :401-447, the scatter of the
//                     reconciled rows into the sweeps' assignments
//                     (:686-689) and the per-read rel risky flag (:700-704).
// The plain torch versions are rel.prep_ref / rescue_ref / pack_ref and
// alldev.prep_ref / settle_ref.
//
// Numerics (built with --fmad=false / -ffp-contract=off, never fast
// math): the E emission and the Poisson planes keep the torch code's
// operation order, log(covE) once per value as torch computes it on a
// 0-d tensor; maxima and minima propagate NaN (tmax, tmin);
// integer sums, products and the floor division are exact int64 as in
// torch (rd::wmul, rd::floordiv2); hdrr divides in IEEE f64; the f32
// margin rounds to nearest (__double2float_rn, as a C cast on the host).
//
// Warp bodies: a row's (or read pair's) columns are dealt to the warp's
// 32 lanes, c = c0 + lane for c0 = 0, 32, ... < max_m (the loop bound is
// a kernel argument, so every lane runs every trip); each lane
// accumulates its columns and a butterfly of shuffles (rd::from_xor)
// gives every lane the row's total, so every lane takes the same row
// decisions.  A warp takes one row (one read pair in rel_settle), so a
// warp leaves the kernel whole.

#pragma once

#include <string.h>

#include "rd_math.cuh"
#include "warp_lanes.cuh"

namespace gl {

using rd::DIP;
using rd::ERR;
using rd::HAP;
using rd::NST;
using rd::REP;
using rd::WARP;

// the warp kernels' column loops stay rolled: unrolled, their passes
// over a row spill registers (rel_settle)
#ifdef __CUDACC__
#define GL_ROLLED _Pragma("unroll 1")
#else
#define GL_ROLLED
#endif

constexpr double EPS = 1e-5;       // rel.REL_MARGIN_EPS
constexpr long long LF_MAX = 32767;
constexpr int P13_N = 13;

// ---------------------------------------------------------------- prep

struct Prep {
  const int* iblob;
  const double* fblob;
  const double* logfact;     // (32768,)
  const long long* gcov;     // (4,) E, R, H, D
  double e_po_base;
  int R, M;                  // read rows (2R scan rows), max_m
  int Bn, N;                 // all-device layout: interval rows, max_n
  double gate_lo, gate_hi;   // an unflagged read's margin gate
  // the DP's planes (kernels.rel_dp's inputs) and the first pass's
  // coverages
  long long *bpos, *bcnt, *epos, *ecnt, *max_cc, *m, *plen, *cov;
  double *lf_bcnt, *logpE;   // lf_bcnt: main layout only
  unsigned char* fwd;
  // all-device layout: the sweeps' inputs and the per-read margin gate
  unsigned char *is_rel, *live;
  int* asgn;
  double *P13, *packL, *packR, *gate;
};

// torch.maximum / torch.minimum: NaN when either operand is NaN; of two
// zeros, on the card the one fmax / fmin pick (PTX max.f64 / min.f64, as
// torch's CUDA kernels: +0 / -0), on the host the second operand (as its
// vectorized CPU kernels)
RD_FN double tmax(double a, double b) {
#ifdef __CUDA_ARCH__
  return (rd::isnan_(a) || rd::isnan_(b)) ? RD_NAN : fmax(a, b);
#else
  return rd::max_(a, b);
#endif
}
RD_FN double tmin(double a, double b) {
#ifdef __CUDA_ARCH__
  return (rd::isnan_(a) || rd::isnan_(b)) ? RD_NAN : fmin(a, b);
#else
  return rd::min_(a, b);
#endif
}

RD_FN double lf_at(const double* logfact, long long k) {
  return RD_LDG(logfact + rd::clampi(k, 0, LF_MAX));
}

// Poisson log-probability k log(lam) - lam - lf(k), lce = log(lam)
RD_FN double pois(double k, double lam, double lce, double lf_k) {
  return k * lce - lam - lf_k;
}

// rel.e_emission: max(Poisson(bcnt) + Poisson(ecnt) at the E coverage +
// e_po_base, the wall's own error log-probability)
RD_FN double e_emission(long long bc, long long ec, double lf_b, double lf_e,
                        double pe_rel, double covEf, double lce,
                        double e_po_base) {
  return tmax(pois((double)bc, covEf, lce, lf_b)
                      + pois((double)ec, covEf, lce, lf_e) + e_po_base,
                  pe_rel);
}

RD_FN void prep_row(const Prep& a, int r2, long long m, long long plen,
                    bool fwd) {
  a.m[r2] = m;
  a.plen[r2] = plen;
  a.fwd[r2] = fwd ? 1 : 0;
  RD_UNROLL
  for (int q = 0; q < 4; ++q) a.cov[4LL * r2 + q] = RD_LDG(a.gcov + q);
}

// Main layout, cell k of the (2R, max_m) planes.  iblob: b, e, ccb, cce
// [4 x R*max_m] | m [R] | plen [R]; fblob: pe [R*max_m].  Backward rows
// read the forward row at the reversed column (within m; padding columns
// keep their index): bpos = e - 1, epos = b, the counts swapped.
RD_FN void prep_main_cell(const Prep& a, long long k) {
  const long long RM = (long long)a.R * a.M;
  const int r2 = (int)(k / a.M);
  const int c = (int)(k - (long long)r2 * a.M);
  const bool bw = r2 >= a.R;
  const int r = bw ? r2 - a.R : r2;
  const long long mr = RD_LDG(a.iblob + 4 * RM + r);
  const long long f = (bw && c < mr) ? mr - 1 - c : c;
  const long long i = (long long)r * a.M + f;
  const long long b = RD_LDG(a.iblob + i);
  const long long e = RD_LDG(a.iblob + RM + i);
  const long long ccb = RD_LDG(a.iblob + 2 * RM + i);
  const long long cce = RD_LDG(a.iblob + 3 * RM + i);
  const long long bc = bw ? cce : ccb;
  const long long ec = bw ? ccb : cce;
  a.bpos[k] = bw ? e - 1 : b;
  a.epos[k] = bw ? b : e - 1;
  a.bcnt[k] = bc;
  a.ecnt[k] = ec;
  a.max_cc[k] = rd::maxi(ccb, cce);
  const double lf_b = lf_at(a.logfact, bc);
  const double lf_e = lf_at(a.logfact, ec);
  const double covEf = (double)RD_LDG(a.gcov + ERR);
  a.lf_bcnt[k] = lf_b;
  a.logpE[k] = e_emission(bc, ec, lf_b, lf_e, RD_LDG(a.fblob + i), covEf,
                          log(covEf), a.e_po_base);
  if (c == 0)
    prep_row(a, r2, mr, RD_LDG(a.iblob + 4 * RM + a.R + r), !bw);
}

// All-device layout (alldev.py): cells [0, R2*max_m) are the rel planes,
// cells [R2*max_m, R2*max_m + Bn*max_n) the interval planes.
RD_FN void prep_alldev_cell(const Prep& a, long long k) {
  const long long UN = (long long)a.Bn * a.N;
  const int R2 = 2 * a.R;
  const long long RM2 = (long long)R2 * a.M;
  const double covEf = (double)RD_LDG(a.gcov + ERR);
  const double lce = log(covEf);
  if (k < RM2) {
    const int* rel = a.iblob + 10 * UN + a.Bn;    // bpos .. max_cc
    const double* frel = a.fblob + 5 * UN;         // pe_rel, lf_bcnt, lf_ecnt
    const long long bc = RD_LDG(rel + RM2 + k);
    const long long ec = RD_LDG(rel + 3 * RM2 + k);
    a.bpos[k] = RD_LDG(rel + k);
    a.bcnt[k] = bc;
    a.epos[k] = RD_LDG(rel + 2 * RM2 + k);
    a.ecnt[k] = ec;
    a.max_cc[k] = RD_LDG(rel + 4 * RM2 + k);
    a.logpE[k] = e_emission(bc, ec, RD_LDG(frel + RM2 + k),
                            RD_LDG(frel + 2 * RM2 + k), RD_LDG(frel + k),
                            covEf, lce, a.e_po_base);
    const int r2 = (int)(k / a.M);
    if (k - (long long)r2 * a.M == 0) {
      const int* rows = rel + 5 * RM2 + (long long)a.R * a.M;  // m, plen, fwd
      prep_row(a, r2, RD_LDG(rows + r2), RD_LDG(rows + R2 + r2),
               RD_LDG(rows + 2 * R2 + r2) != 0);
    }
    return;
  }
  k -= RM2;
  // iblob: b, e, cb, ce, ccb, cce, idx_desc, idx_asc, is_rel, live
  // [10 x Bn*max_n]; fblob: pe, peob, peoe, lf_cb, lf_ce [5 x Bn*max_n]
  const double b = (double)RD_LDG(a.iblob + k);
  const double e1 = (double)(RD_LDG(a.iblob + UN + k) - 1);
  const double cb = (double)RD_LDG(a.iblob + 2 * UN + k);
  const double ce = (double)RD_LDG(a.iblob + 3 * UN + k);
  const double lf_cb = RD_LDG(a.fblob + 3 * UN + k);
  const double lf_ce = RD_LDG(a.fblob + 4 * UN + k);
  const double covHf = (double)RD_LDG(a.gcov + HAP);
  const double covDf = (double)RD_LDG(a.gcov + DIP);
  const double lch = log(covHf), lcd = log(covDf);
  double* p = a.P13 + P13_N * k;
  p[0] = cb;
  p[1] = ce;
  p[2] = lf_cb;
  p[3] = lf_ce;
  p[4] = b;
  p[5] = e1;
  p[6] = tmax(RD_LDG(a.fblob + k),
                  pois(cb, covEf, lce, lf_cb) + pois(ce, covEf, lce, lf_ce)
                      + a.e_po_base);
  p[7] = pois(cb, covHf, lch, lf_cb);
  p[8] = pois(ce, covHf, lch, lf_ce);
  p[9] = pois(cb, covDf, lcd, lf_cb);
  p[10] = pois(ce, covDf, lcd, lf_ce);
  p[11] = RD_LDG(a.fblob + UN + k);
  p[12] = RD_LDG(a.fblob + 2 * UN + k);
  double* L = a.packL + 3 * k;
  L[0] = (double)RD_LDG(a.iblob + 5 * UN + k);
  L[1] = e1;
  L[2] = ce;
  double* Rr = a.packR + 3 * k;
  Rr[0] = (double)RD_LDG(a.iblob + 4 * UN + k);
  Rr[1] = b;
  Rr[2] = cb;
  a.is_rel[k] = RD_LDG(a.iblob + 8 * UN + k) != 0;
  a.live[k] = RD_LDG(a.iblob + 9 * UN + k) != 0;
  a.asgn[k] = NST;
  if (k % a.N == 0) {
    const long long row = k / a.N;
    a.gate[row] = a.gate_lo;
    a.gate[a.Bn + row] = a.gate_hi;
  }
}

// ------------------------------------------------------ lane reductions

// int64 sum that wraps, as torch's does
RD_FN long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// every lane of the warp gets the warp's sum / min / max of v
template <int NL>
RD_FN void warp_sum(long long (&v)[NL], const int (&wl)[NL]) {
  RD_UNROLL
  for (int off = WARP / 2; off > 0; off >>= 1) {
    long long o[NL];
    rd::from_xor<NL>(v, wl, off, o);
    for (int l = 0; l < NL; ++l) v[l] = wadd(v[l], o[l]);
  }
}
template <int NL>
RD_FN void warp_min(long long (&v)[NL], const int (&wl)[NL]) {
  RD_UNROLL
  for (int off = WARP / 2; off > 0; off >>= 1) {
    long long o[NL];
    rd::from_xor<NL>(v, wl, off, o);
    for (int l = 0; l < NL; ++l) v[l] = rd::mini(v[l], o[l]);
  }
}
template <int NL>
RD_FN void warp_max(long long (&v)[NL], const int (&wl)[NL]) {
  RD_UNROLL
  for (int off = WARP / 2; off > 0; off >>= 1) {
    long long o[NL];
    rd::from_xor<NL>(v, wl, off, o);
    for (int l = 0; l < NL; ++l) v[l] = rd::maxi(v[l], o[l]);
  }
}

template <int NL>
RD_FN void fill(long long (&v)[NL], long long x) {
  for (int l = 0; l < NL; ++l) v[l] = x;
}

// the warp lanes of the launch's threads g0 .. g0 + NL - 1 and their row
// (one row per warp; the host shim's g0 is a multiple of 32)
template <int NL>
RD_FN long long lanes_of(long long g0, int (&wl)[NL]) {
  for (int l = 0; l < NL; ++l) wl[l] = (int)((g0 + l) & (WARP - 1));
  return g0 / WARP;
}

RD_FN bool risky(double v) { return v > 0.0 && v < EPS; }

// IEEE division, as torch divides two f64 tensors
RD_FN double div_(double a, double b) { return a / b; }

// |p - 1| <= |q - 1| in the exact int64 form of the demotions: the mean
// csum / lsum nearer (or as near) gH than gD
RD_FN long long dist(long long csum, long long g, long long lsum) {
  return rd::wabs(rd::wsub(csum, rd::wmul(g, lsum)));
}

// interval length |epos - bpos| + 1 and the half count floor((bcnt +
// ecnt) * l / 2) of plane cell i
RD_FN long long cell_len(const long long* bpos, const long long* epos,
                         long long i) {
  return wadd(rd::wabs(rd::wsub(RD_LDG(epos + i), RD_LDG(bpos + i))), 1);
}
RD_FN long long cell_half(const long long* bcnt, const long long* ecnt,
                          long long i, long long l) {
  return rd::floordiv2(rd::wmul(wadd(RD_LDG(bcnt + i), RD_LDG(ecnt + i)),
                                l));
}

// -------------------------------------------------------------- rescue

struct Rescue {
  const long long *bpos, *bcnt, *epos, *ecnt, *m;   // the DP's planes
  const signed char* asgn;                           // first pass (R2, M)
  const long long* gcov;
  int R2, M;
  unsigned char* rescue;                             // (R2,)
  long long* cov2;                                   // (R2, 4)
};

// rel.rescue_rows on row g0 / 32: the D intervals' length sum, half-count
// sum and first column (keyed min (col << 16) + bcnt, bcnt <= 32767), the
// H count; rescue = no H, some D, csum < gD * lsum.
template <int NL>
RD_FN void rescue_warp(const Rescue& a, long long g0) {
  int wl[NL];
  const long long row = lanes_of<NL>(g0, wl);
  if (row >= a.R2) return;
  const long long mr = RD_LDG(a.m + row);
  const long long big = (long long)a.M << 16;
  long long lsum[NL], csum[NL], nh[NL], key[NL];
  fill<NL>(lsum, 0);
  fill<NL>(csum, 0);
  fill<NL>(nh, 0);
  fill<NL>(key, big);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP) {
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M || c >= mr) continue;
      const long long i = row * a.M + c;
      const int v = RD_LDG(a.asgn + i);
      if (v == HAP) nh[l] += 1;
      if (v != DIP) continue;
      const long long len = cell_len(a.bpos, a.epos, i);
      lsum[l] = wadd(lsum[l], len);
      csum[l] = wadd(csum[l], cell_half(a.bcnt, a.ecnt, i, len));
      key[l] = rd::mini(key[l], ((long long)c << 16) + RD_LDG(a.bcnt + i));
    }
  }
  warp_sum<NL>(lsum, wl);
  warp_sum<NL>(csum, wl);
  warp_sum<NL>(nh, wl);
  warp_min<NL>(key, wl);
  for (int l = 0; l < NL; ++l) {
    if (wl[l] != 0) continue;
    const long long gH = RD_LDG(a.gcov + HAP), gD = RD_LDG(a.gcov + DIP);
    const bool res = nh[l] == 0 && key[l] < big
                     && csum[l] < rd::wmul(gD, lsum[l]);
    const long long anchor = key[l] & 0xFFFF;
    a.rescue[row] = res ? 1 : 0;
    long long* cv = a.cov2 + 4 * row;
    cv[ERR] = RD_LDG(a.gcov + ERR);
    cv[REP] = RD_LDG(a.gcov + REP);
    cv[HAP] = res ? anchor : gH;
    cv[DIP] = res ? wadd(anchor, gH) : gD;
  }
}

// ---------------------------------------------------------------- pack

struct Pack {
  const signed char *asgn1, *asgn2;   // the two passes (R2, M)
  const double *mm1, *mm2;            // their margins (R2,)
  const unsigned char* rescue;        // (R2,)
  int R2, M;
  unsigned char* out;                 // (R2, M + 5)
};

// the margin of a row after both passes: rescued rows' decisions came
// from both, so theirs is the min of the two
RD_FN double merged_mm(const double* mm1, const double* mm2, bool res,
                       long long row) {
  const double m1 = RD_LDG(mm1 + row);
  return res ? tmin(m1, RD_LDG(mm2 + row)) : m1;
}

RD_FN unsigned f32_bits(double v) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(__double2float_rn(v));
#else
  const float f = (float)v;
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

// rel.pack_ref on row g0 / 32: [asgn bytes of the pass the row keeps |
// flags (bit 0 risky, bit 1 rescue) | f32(margin), little-endian]
template <int NL>
RD_FN void pack_warp(const Pack& a, long long g0) {
  int wl[NL];
  const long long row = lanes_of<NL>(g0, wl);
  if (row >= a.R2) return;
  const bool res = RD_LDG(a.rescue + row) != 0;
  const signed char* src = (res ? a.asgn2 : a.asgn1) + row * a.M;
  unsigned char* dst = a.out + row * (a.M + 5);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c < a.M) dst[c] = (unsigned char)RD_LDG(src + c);
    }
  for (int l = 0; l < NL; ++l) {
    if (wl[l] > 4) continue;
    const double mm = merged_mm(a.mm1, a.mm2, res, row);
    dst[a.M + wl[l]] = wl[l] == 0
        ? (unsigned char)((risky(mm) ? 1 : 0) | (res ? 2 : 0))
        : (unsigned char)(f32_bits(mm) >> (8 * (wl[l] - 1)));
  }
}

// -------------------------------------------------------------- settle

struct Settle {
  const signed char *asgn1, *asgn2;
  const double *mm1, *mm2;
  const unsigned char* rescue;
  const long long *bpos, *bcnt, *epos, *ecnt, *m;   // the DP's planes
  const unsigned char* fwd;
  const int *rel_rows, *rel_cols;                   // (R,), (R, M)
  const long long* gcov;
  int R, M, Bn, N;
  int* asgn;                                        // (Bn, N) sweep input
  double* gate;                                     // (2, Bn) margin gate
};

// one scan row through the three demotion stages: the stage decisions
// taken so far (each stage reads the previous stage's result)
struct Row {
  long long r, m;
  bool res, flip1, flip2, dem3;
};

RD_FN Row row_of(const Settle& a, long long r) {
  Row d;
  d.r = r;
  d.m = RD_LDG(a.m + r);
  d.res = RD_LDG(a.rescue + r) != 0;
  d.flip1 = d.flip2 = d.dem3 = false;
  return d;
}

// the row's state at column c after the stages decided so far
// (alldev.demotes_dev): no-H rescue rows D -> H (every column), all-H rows
// H -> D, >= 70%-H rows H -> D and D -> R (columns < m)
RD_FN int state(const Settle& a, const Row& d, int c) {
  const long long i = d.r * a.M + c;
  int v = d.res ? RD_LDG(a.asgn2 + i) : RD_LDG(a.asgn1 + i);
  if (d.flip1 && v == DIP) v = HAP;
  const bool inb = c < d.m;
  if (d.flip2 && inb && v == HAP) v = DIP;
  if (d.dem3 && inb) v = v == HAP ? DIP : (v == DIP ? REP : v);
  return v;
}

// stage 1 (class_rel.c:650-669): the D intervals' sums and the H presence;
// stage 2's sums over every interval come with them
template <int NL>
RD_FN void stage1(const Settle& a, Row& d, const int (&wl)[NL],
                  long long& lsum_a, long long& csum_a) {
  long long hs[NL], ls[NL], cs[NL], la[NL], ca[NL];
  fill<NL>(hs, 0);
  fill<NL>(ls, 0);
  fill<NL>(cs, 0);
  fill<NL>(la, 0);
  fill<NL>(ca, 0);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M || c >= d.m) continue;
      const long long i = d.r * a.M + c;
      const int v = state(a, d, c);
      const long long len = cell_len(a.bpos, a.epos, i);
      const long long h = cell_half(a.bcnt, a.ecnt, i, len);
      la[l] = wadd(la[l], len);
      ca[l] = wadd(ca[l], h);
      if (v == HAP) hs[l] = 1;
      if (v == DIP) {
        ls[l] = wadd(ls[l], len);
        cs[l] = wadd(cs[l], h);
      }
    }
  warp_max<NL>(hs, wl);
  warp_sum<NL>(ls, wl);
  warp_sum<NL>(cs, wl);
  warp_sum<NL>(la, wl);
  warp_sum<NL>(ca, wl);
  const long long gH = RD_LDG(a.gcov + HAP), gD = RD_LDG(a.gcov + DIP);
  // lsum == 0: C's 0.0/0 mean is NaN and its compare false
  d.flip1 = d.res && hs[0] == 0 && ls[0] > 0
            && dist(cs[0], gH, ls[0]) <= dist(cs[0], gD, ls[0]);
  lsum_a = la[0];
  csum_a = ca[0];
}

// stage 2 (class_rel.c:674-690): all-H rows whose mean sits nearer (or as
// near) gD
template <int NL>
RD_FN void stage2(const Settle& a, Row& d, const int (&wl)[NL],
                  long long lsum_a, long long csum_a) {
  long long nonh[NL];
  fill<NL>(nonh, 0);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c < a.M && c < d.m && state(a, d, c) != HAP) nonh[l] = 1;
    }
  warp_max<NL>(nonh, wl);
  const long long gH = RD_LDG(a.gcov + HAP), gD = RD_LDG(a.gcov + DIP);
  d.flip2 = nonh[0] == 0
            && dist(csum_a, gH, lsum_a) >= dist(csum_a, gD, lsum_a);
}

// stage 3 (class_rel.c:692-713): rows with >= 70% H (the product in f64,
// as JAX takes it) whose H mean sits nearer (or as near) gD
template <int NL>
RD_FN void stage3(const Settle& a, Row& d, const int (&wl)[NL]) {
  long long nh[NL], ls[NL], cs[NL];
  fill<NL>(nh, 0);
  fill<NL>(ls, 0);
  fill<NL>(cs, 0);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M || c >= d.m || state(a, d, c) != HAP) continue;
      const long long i = d.r * a.M + c;
      const long long len = cell_len(a.bpos, a.epos, i);
      nh[l] += 1;
      ls[l] = wadd(ls[l], len);
      cs[l] = wadd(cs[l], cell_half(a.bcnt, a.ecnt, i, len));
    }
  warp_sum<NL>(nh, wl);
  warp_sum<NL>(ls, wl);
  warp_sum<NL>(cs, wl);
  const long long gH = RD_LDG(a.gcov + HAP), gD = RD_LDG(a.gcov + DIP);
  d.dem3 = (double)nh[0] >= (double)d.m * 0.7 && ls[0] > 0
           && dist(cs[0], gH, ls[0]) >= dist(cs[0], gD, ls[0]);
}

template <int NL>
RD_FN void demote(const Settle& a, Row& d, const int (&wl)[NL]) {
  long long lsum_a, csum_a;
  stage1<NL>(a, d, wl, lsum_a, csum_a);
  stage2<NL>(a, d, wl, lsum_a, csum_a);
  stage3<NL>(a, d, wl);
}

// the hdrr of a demoted row (alldev.reconcile_dev): the first D and H
// entering counts over the last D and H leaving counts (fw rows; the
// inverse on bw rows), 1.0 without both states
template <int NL>
RD_FN double hdrr(const Settle& a, const Row& d, const int (&wl)[NL]) {
  long long fd[NL], fh[NL], ld[NL], lh[NL];
  fill<NL>(fd, a.M);
  fill<NL>(fh, a.M);
  fill<NL>(ld, -1);
  fill<NL>(lh, -1);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M || c >= d.m) continue;
      const int v = state(a, d, c);
      if (v == DIP) {
        fd[l] = rd::mini(fd[l], c);
        ld[l] = rd::maxi(ld[l], c);
      } else if (v == HAP) {
        fh[l] = rd::mini(fh[l], c);
        lh[l] = rd::maxi(lh[l], c);
      }
    }
  warp_min<NL>(fd, wl);
  warp_min<NL>(fh, wl);
  warp_max<NL>(ld, wl);
  warp_max<NL>(lh, wl);
  if (fd[0] >= a.M || fh[0] >= a.M) return 1.0;
  const long long o = d.r * a.M;
  const double p = div_((double)RD_LDG(a.bcnt + o + fd[0]),
                        (double)RD_LDG(a.bcnt + o + fh[0]));
  const double q = div_((double)RD_LDG(a.ecnt + o + ld[0]),
                        (double)RD_LDG(a.ecnt + o + lh[0]));
  return RD_LDG(a.fwd + d.r) ? div_(p, q) : div_(q, p);
}

// column c of the forward order from its scan-order row: the reversal
// within m (padding columns keep their index)
RD_FN int flip_col(long long m, int c) {
  return c < m ? (int)(m - 1 - c) : c;
}

// alldev.settle_ref for read pair g0 / 32 (rows j and R + j): merge the
// passes, demote both rows, reconcile them (class_rel.c:847-938), write
// the reconciled row into the sweeps' assignments at (rel_rows[j],
// rel_cols[j, c]) (sentinel rows and columns dropped) and open the read's
// margin gate when either row's margin is risky.
template <int NL>
RD_FN void settle_warp(const Settle& a, long long g0) {
  int wl[NL];
  const long long j = lanes_of<NL>(g0, wl);
  if (j >= a.R) return;
  const long long x = RD_LDG(a.rel_rows + j);
  if (x < 0 || x >= a.Bn) return;       // a padding row: nothing to write
  Row f = row_of(a, j), b = row_of(a, a.R + j);
  demote<NL>(a, f, wl);
  demote<NL>(a, b, wl);
  const double hf = hdrr<NL>(a, f, wl);
  const double hb = hdrr<NL>(a, b, wl);

  // eq (fw == reversed bw within m); the first zero of the row and of its
  // reversal (is_eq_prefix / is_eq_suffix)
  long long neq[NL], fz[NL], fzr[NL];
  fill<NL>(neq, 0);
  fill<NL>(fz, f.m);
  fill<NL>(fzr, f.m);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M || c >= f.m) continue;
      const int vf = state(a, f, c);
      if (vf != state(a, b, flip_col(f.m, c))) neq[l] = 1;
      if (vf == 0) fz[l] = rd::mini(fz[l], c);
      if (state(a, f, flip_col(f.m, c)) == 0) fzr[l] = rd::mini(fzr[l], c);
    }
  warp_max<NL>(neq, wl);
  warp_min<NL>(fz, wl);
  warp_min<NL>(fzr, wl);
  // a non-zero state at or after the first zero
  long long nz[NL], nzr[NL];
  fill<NL>(nz, 0);
  fill<NL>(nzr, 0);
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M || c >= f.m) continue;
      if (c >= fz[0] && state(a, f, c) != 0) nz[l] = 1;
      if (c >= fzr[0] && state(a, f, flip_col(f.m, c)) != 0) nzr[l] = 1;
    }
  warp_max<NL>(nz, wl);
  warp_max<NL>(nzr, wl);
  const bool is_prefix = state(a, f, 0) == REP && nz[0] == 0;
  const bool is_suffix =
      state(a, f, (int)rd::maxi(f.m - 1, 0)) == REP && nzr[0] == 0;
  const bool keep_f = fabs(hf - 1.0) <= fabs(hb - 1.0);
  const bool take_b = neq[0] != 0 && !is_prefix && (is_suffix || !keep_f);

  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += WARP)
    for (int l = 0; l < NL; ++l) {
      const int c = c0 + wl[l];
      if (c >= a.M) continue;
      const long long col = RD_LDG(a.rel_cols + j * a.M + c);
      if (col < 0 || col >= a.N) continue;
      a.asgn[x * a.N + col] =
          take_b ? state(a, b, flip_col(f.m, c)) : state(a, f, c);
    }
  for (int l = 0; l < NL; ++l) {
    if (wl[l] != 0) continue;
    if (risky(merged_mm(a.mm1, a.mm2, f.res, f.r))
        || risky(merged_mm(a.mm1, a.mm2, b.res, b.r))) {
      a.gate[x] = -RD_INF;
      a.gate[a.Bn + x] = RD_INF;
    }
  }
}

}  // namespace gl
