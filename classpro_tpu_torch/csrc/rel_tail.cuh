// The rel stage's per-row tails and the helpers they share with the glue.
//
// The DP kernel (rel_dp_row.cuh) ends each of its rows with two optional
// tails, run by the row's eight lanes right after its traceback:
//   rescue  the no-H rescue predicate and the rescue pass's coverages
//           (device_pipeline._rel_pipeline :198-234; rel.rescue_rows), on
//           the first pass;
//   pack    the row's packed result (the pass merge :237-241 and
//           _pack_out :638-651; rel.pack_out): [its assignment bytes |
//           flags (bit 0 risky, bit 1 rescued) | f32(margin),
//           little-endian].  The first pass writes the rows it does not
//           rescue, the rescue pass the rows it runs, with the min of both
//           passes' margins, so the two launches write each packed byte
//           once.
// Both read only their own row, so no grid-wide step stands between the
// DP and them.  This header holds what a tail computes per cell and per
// row; the loop over a row's columns and the lane reductions are the DP
// kernel's epilogue.  glue_row.cuh takes the integer and margin helpers
// (tmax, tmin, wadd, risky, seg_len, seg_half) for rel_settle.
//
// Numerics: exact int64 as torch's (wrapping sums in any order,
// rd::wmul, rd::floordiv2); maxima and minima propagate NaN (tmax,
// tmin); the f32 margin rounds to nearest (__double2float_rn, a C cast
// on the host).

#pragma once

#include <string.h>

#include "rd_math.cuh"

namespace gl {

using rd::DIP;
using rd::ERR;
using rd::HAP;
using rd::REP;

constexpr double EPS = 1e-5;       // rel.REL_MARGIN_EPS

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

// int64 sum that wraps, as torch's does
RD_FN long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

RD_FN bool risky(double v) { return v > 0.0 && v < EPS; }

// interval length |epos - bpos| + 1 and the half count floor((bcnt +
// ecnt) * l / 2)
RD_FN long long seg_len(long long bpos, long long epos) {
  return wadd(rd::wabs(rd::wsub(epos, bpos)), 1);
}
RD_FN long long seg_half(long long bcnt, long long ecnt, long long l) {
  return rd::floordiv2(rd::wmul(wadd(bcnt, ecnt), l));
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

// A lane's share of the rescue predicate's sums over its row's columns
// within m: the D intervals' length sum, half-count sum and first column
// (keyed min (col << 16) + bcnt, bcnt <= 32767), the H count.
struct RescueSums {
  long long lsum, csum, nh, key;
};

RD_FN RescueSums rescue_start(int M) {
  return RescueSums{0, 0, 0, (long long)M << 16};
}

// column c of the row: state v, the interval's planes
RD_FN void rescue_cell(RescueSums& s, int v, int c, long long bpos,
                       long long bcnt, long long epos, long long ecnt) {
  if (v == HAP) s.nh += 1;
  if (v != DIP) return;
  const long long len = seg_len(bpos, epos);
  s.lsum = wadd(s.lsum, len);
  s.csum = wadd(s.csum, seg_half(bcnt, ecnt, len));
  s.key = rd::mini(s.key, ((long long)c << 16) + bcnt);
}

// the row's decision from its summed RescueSums: rescue = no H, some D
// and csum < gD * lsum; the rescue pass's coverages into cov2[0..3] (the
// H coverage the first D's entering count, D that plus gH)
RD_FN bool rescue_decide(const RescueSums& s, const long long* gcov, int M,
                         long long* cov2) {
  const long long gH = RD_LDG(gcov + HAP), gD = RD_LDG(gcov + DIP);
  const bool res = s.nh == 0 && s.key < ((long long)M << 16)
                   && s.csum < rd::wmul(gD, s.lsum);
  const long long anchor = s.key & 0xFFFF;
  cov2[ERR] = RD_LDG(gcov + ERR);
  cov2[REP] = RD_LDG(gcov + REP);
  cov2[HAP] = res ? anchor : gH;
  cov2[DIP] = res ? wadd(anchor, gH) : gD;
  return res;
}

// byte k (0..4) of a packed row's tail: the flags (bit 0 risky, bit 1
// rescued), then the four bytes of f32(mm), little-endian
RD_FN unsigned char pack_tail_byte(int k, double mm, bool rescued) {
  return k == 0 ? (unsigned char)((risky(mm) ? 1 : 0) | (rescued ? 2 : 0))
                : (unsigned char)(f32_bits(mm) >> (8 * (k - 1)));
}

// byte k of row ``row``'s packed tail as a pass writes it, ``mm`` the
// pass's margin: the first pass (mm_prev null) a row it keeps, the
// rescue pass a rescued row with the min of both passes' margins (the
// merge, device_pipeline.py:237-241)
RD_FN unsigned char row_tail_byte(int k, const double* mm_prev,
                                  long long row, double mm) {
  return mm_prev ? pack_tail_byte(k, tmin(RD_LDG(mm_prev + row), mm), true)
                 : pack_tail_byte(k, mm, false);
}

}  // namespace gl
