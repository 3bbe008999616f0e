// The DP's plane values of one cell from a chunk's blobs: the arithmetic
// that the DP kernel's first-pass prologue (rel_dp_row.cuh) runs for the
// main layout and that the all-device rel_prep (glue_row.cuh) shares (the
// log-factorial lookup, the Poisson terms, the E emission).
//
// Replaces, in the JAX package's device_pipeline.py, _rel_only_core
// :572-626 (both scan directions from the forward-order blobs, the
// log-factorial lookups) and the E emission of _rel_pipeline :170-174;
// rel.prep_ref is the plain torch version.
//
// Numerics (built with --fmad=false / -ffp-contract=off, never fast
// math): the torch code's operation order; log(cov) of the E coverage as
// torch computes it on a 0-d tensor (the same log of the same double);
// maxima propagate NaN (tmax).

#pragma once

#include "rd_math.cuh"
#include "rel_tail.cuh"

namespace gl {

constexpr long long LF_MAX = 32767;

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

// Main layout.  iblob: b, e, ccb, cce [4 x R*max_m] | m [R] | plen [R];
// fblob: pe [R*max_m].  Scan row r2 < R is read row r2 forward, r2 >= R
// read row r2 - R backward: column c reads the forward row's column
// main_col (reversed within m; padding columns keep their index), with
// bpos = e - 1, epos = b and the counts swapped.

// the forward column that column c of a row reads
RD_FN long long main_col(bool bw, long long c, long long mr) {
  return (bw && c < mr) ? mr - 1 - c : c;
}

// the counts a scan row's column takes from its blob values
RD_FN long long main_bcnt(bool bw, long long ccb, long long cce) {
  return bw ? cce : ccb;
}
RD_FN long long main_ecnt(bool bw, long long ccb, long long cce) {
  return bw ? ccb : cce;
}

// one cell of the DP's planes (kernels.rel_dp's inputs)
struct MainCell {
  long long bpos, bcnt, epos, ecnt, max_cc;
  double lf_bcnt, logpE;
};

// cell's planes from its blob values b, e, ccb, cce, pe and the
// log-factorials of its two counts; covEf the E coverage, lce its log
RD_FN MainCell main_cell(bool bw, long long b, long long e, long long ccb,
                         long long cce, double pe, double lf_b, double lf_e,
                         double covEf, double lce, double e_po_base) {
  MainCell o;
  o.bcnt = main_bcnt(bw, ccb, cce);
  o.ecnt = main_ecnt(bw, ccb, cce);
  o.bpos = bw ? e - 1 : b;
  o.epos = bw ? b : e - 1;
  o.max_cc = rd::maxi(ccb, cce);
  o.lf_bcnt = lf_b;
  o.logpE = e_emission(o.bcnt, o.ecnt, lf_b, lf_e, pe, covEf, lce,
                       e_po_base);
  return o;
}

}  // namespace gl
