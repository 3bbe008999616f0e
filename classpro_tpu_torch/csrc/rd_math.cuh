// Arithmetic shared by the DP kernel (rel_dp_row.cuh) and the sweep
// kernel (unrel_row.cuh): the NaN-propagating size-4 maxima and margins,
// XLA-like float -> int64 casts, int64 wrap-around and the packed
// log-Skellam lookup.  __host__ __device__ under nvcc; under g++ -x c++ the
// same code builds the host test shims.
//
// Numerics (the builds use --fmad=false / -ffp-contract=off, never fast
// math): every expression keeps the reference's operation order; the
// size-4 maxima propagate NaN (fmax would drop it) with a strict-'>'
// first-wins index; float -> int64 casts saturate (NaN -> 0) like XLA's;
// _div_cr is plain IEEE division.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RD_FN __host__ __device__ __forceinline__
#define RD_UNROLL _Pragma("unroll")
#else
#define RD_FN static inline
#define RD_UNROLL
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
  RD_UNROLL
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
  RD_UNROLL
  for (int k = 0; k < 4; ++k) ms[k] = (am == k) ? -RD_INF : x[k];
  double top2 = max4(ms[0], ms[1], ms[2], ms[3]);
  double mgn = top1 - top2;
  if (top2 == -RD_INF) mgn = RD_INF;
  return isnan_(mgn) ? 1e-30 : mgn;
}

// XLA float -> int64: toward zero, saturating, NaN -> 0.  On the card
// the hardware conversion (cvt.rzi.s64.f64) clamps out-of-range values
// but turns NaN into INT64_MIN, so NaN is selected to 0 beside it, without
// the branches of the portable form; both forms are held to the rule at
// NaN, +-inf and +-2^63 by
// tests/test_torch_kernel_shim.py::test_sat_i64_is_the_xla_cast.
RD_FN long long sat_i64(double x) {
#ifdef __CUDA_ARCH__
  const long long v = __double2ll_rz(x);
  return isnan_(x) ? 0LL : v;
#else
  if (isnan_(x)) return 0;
  if (x >= 9223372036854775808.0) return 0x7fffffffffffffffLL;
  if (x < -9223372036854775808.0) return -0x7fffffffffffffffLL - 1;
  return (long long)x;
#endif
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
// Lagrange over the packed table, C's overflow/underflow cutoffs.  Split
// into the record's address (skellam_args), its 40-byte gather and the
// interpolation (skellam_value), so that a caller can issue several
// gathers before it waits for the first; skellam() is the three in a row.
struct SkArgs {
  int k, n;
  double lam, x, f;
  bool in_a;
  long long rec;   // record index into the (NMAX+1, NCOL) grid
};
struct SkRec {
  double y0, y1, y2, y3, lf_n;
};

RD_FN SkArgs skellam_args(long long k64, double lam) {
  SkArgs s;
  int kw = (int)(unsigned int)(unsigned long long)k64;   // int32 wrap
  s.k = kw < 0 ? (int)(0u - (unsigned int)kw) : kw;      // jnp.abs
  s.lam = lam;
  double x = 2.0 * lam;
  x = x < 0.0 ? 0.0 : x;
  x = x > XB_MAX ? XB_MAX : x;
  s.x = x;
  s.n = s.k < 0 ? 0 : (s.k > NMAX ? NMAX : s.k);

  double pos_a = x * POS_A;
  int i1a = (int)floor(pos_a);
  i1a = i1a < 1 ? 1 : (i1a > NA_GRID - 3 ? NA_GRID - 3 : i1a);
  double fa = pos_a - (double)i1a;
  double u = sqrt(x);
  double pos_b = (u - 8.0) / DU;
  int i1b = (int)floor(pos_b);
  i1b = i1b < 1 ? 1 : (i1b > NB_GRID - 3 ? NB_GRID - 3 : i1b);
  double fb = pos_b - (double)i1b;
  s.in_a = x <= XA_MAX;
  int idx = s.in_a ? i1a : NA_GRID + i1b;
  s.f = s.in_a ? fa : fb;
  s.rec = (long long)s.n * NCOL + idx;
  return s;
}

RD_FN SkRec skellam_load(const SkArgs& s, const double* tab) {
  const double* nd = tab + s.rec * 5;
  SkRec r;
  r.y0 = RD_LDG(nd);
  r.y1 = RD_LDG(nd + 1);
  r.y2 = RD_LDG(nd + 2);
  r.y3 = RD_LDG(nd + 3);
  r.lf_n = RD_LDG(nd + 4);
  return r;
}

RD_FN double skellam_value(const SkArgs& s, const SkRec& r) {
  const double f = s.f, x = s.x;
  const int n = s.n;
  double w0 = -f * (f - 1.0) * (f - 2.0) / 6.0;
  double w1 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0;
  double w2 = -(f + 1.0) * f * (f - 2.0) / 2.0;
  double w3 = (f + 1.0) * f * (f - 1.0) / 6.0;
  double val = w0 * r.y0 + w1 * r.y1 + w2 * r.y2 + w3 * r.y3;

  double log_xh = x > 0.0 ? log(x / 2.0) : -RD_INF;
  double val_a = val + (double)n * log_xh - r.lf_n;
  if (x == 0.0 && n == 0) val_a = 0.0;
  double val_b = val + x;
  double out = s.in_a ? val_a : val_b;
  if (x >= OVF || out > OVF) out = RD_INF;
  if (out < UNF) out = -RD_INF;
  out = -2.0 * s.lam + out;
  return s.k > NMAX ? -RD_INF : out;
}

RD_FN double skellam(long long k64, double lam, const double* tab) {
  SkArgs s = skellam_args(k64, lam);
  return skellam_value(s, skellam_load(s, tab));
}

}  // namespace rd
