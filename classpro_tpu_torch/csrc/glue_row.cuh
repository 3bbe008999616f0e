// The per-chunk glue around the DP kernel (K4) and the sweep kernel (K6):
// the per-cell and per-block bodies of the two glue kernels of glue.cu.
// Shared by the CUDA kernels (nvcc: one thread is one lane) and the host
// test shim (the same file under g++ -x c++: one call runs a block's
// threads, phase by phase), so the CPU tests exercise the kernels' own
// arithmetic and block reductions.
//
// Replaces, in the JAX package's device_pipeline.py:
//   prep_alldev_block  _unpack :119 (the rel planes as int64), the E
//                      emission, _un_planes :511-538 and the sweeps'
//                      N_STATE assignment rows of classify_batch_dev :686;
//   settle_block       the pass merge, _demotes_dev :257-294,
//                      _reconcile_dev :401-447, the scatter of the
//                      reconciled rows into the sweeps' assignments
//                      (:686-689) and the per-read rel risky flag
//                      (:700-704).
// The plain torch versions are alldev.prep_ref / settle_ref.  The main
// layout's planes, the rescue predicate and the pack, once glue kernels
// of their own, are the DP kernel's prologue (its cell in prep_cell.cuh)
// and row tails (rel_tail.cuh).
//
// Numerics (built with --fmad=false / -ffp-contract=off, never fast
// math): the E emission and the Poisson planes keep the torch code's
// operation order, log(cov) of each coverage as torch computes it on a
// 0-d tensor (the same log of the same double, once per block in the
// all-device prep); maxima and minima propagate NaN (tmax, tmin);
// integer sums, products and the floor division are exact int64 as in
// torch (rd::wmul, rd::floordiv2), wrapping sums in any order; hdrr
// divides in IEEE f64; the f32 margin rounds to nearest
// (__double2float_rn, as a C cast on the host).
//
// Block bodies (the all-device rel_prep, rel_settle): template <int NT>
// runs threads t0 .. t0 + NT - 1 of a block, NT = 1 on the card and the
// whole block in the shim; each phase between two barriers (block_sync)
// is a loop over those threads, so the shim finishes a phase for every
// thread before the next begins, as the barrier makes the card do.  A
// block leaves the kernel whole (its exit tests read per-block values).

#pragma once

#include "prep_cell.cuh"
#include "rd_math.cuh"
#include "rel_tail.cuh"
#include "warp_lanes.cuh"

namespace gl {

using rd::DIP;
using rd::ERR;
using rd::HAP;
using rd::NST;
using rd::REP;
using rd::WARP;

// rel_settle's column loops stay rolled: unrolled, their passes over a
// row spill registers
#ifdef __CUDACC__
#define GL_ROLLED _Pragma("unroll 1")
#else
#define GL_ROLLED
#endif

constexpr int P13_N = 13;

// ---------------------------------------------------------------- prep

struct Prep {
  const int* iblob;
  const double* fblob;
  const double* logfact;     // (32768,)
  const long long* gcov;     // (4,) E, R, H, D
  double e_po_base;
  int R, M;                  // read rows (2R scan rows), max_m
  int Bn, N;                 // interval rows, max_n
  double gate_lo, gate_hi;   // an unflagged read's margin gate
  // the DP's planes (kernels.rel_dp's inputs; lf_bcnt is a view of the
  // blob) and the first pass's coverages
  long long *bpos, *bcnt, *epos, *ecnt, *max_cc, *m, *plen, *cov;
  double* logpE;
  unsigned char* fwd;
  // the sweeps' inputs and the per-read margin gate
  unsigned char *is_rel, *live;
  int* asgn;
  double *P13, *packL, *packR, *gate;
};

RD_FN void prep_row(const Prep& a, int r2, long long m, long long plen,
                    bool fwd) {
  a.m[r2] = m;
  a.plen[r2] = plen;
  a.fwd[r2] = fwd ? 1 : 0;
  RD_UNROLL
  for (int q = 0; q < 4; ++q) a.cov[4LL * r2 + q] = RD_LDG(a.gcov + q);
}

// ------------------------------------------- prep, all-device layout
//
// All-device layout (alldev.py): a block takes a tile of PREP_TILE
// consecutive cells, either of the (R2, max_m) rel planes (the first
// prep_rel_tiles blocks) or of the (Bn, max_n) interval planes (the
// rest), one thread per cell.  Rel tiles write the DP's planes, each a
// plane of its own and so coalesced as the threads write them.  Interval
// tiles build their cells' P13 (13 doubles), packL and packR (3 each)
// records in shared memory, then the block writes the tile's records out
// as one contiguous run per output: 16-byte stores where the run starts
// 16-byte aligned, 8-byte ones otherwise.  The three logs of the chunk's
// coverages are taken once per block.  A row's own outputs (m, plen, fwd,
// cov; the margin gate) go to the threads whose cell index is that row's
// index, so no thread divides.

constexpr int PREP_TILE = 256;         // cells (threads) per block
constexpr int PU_DOUBLES = P13_N + 6;  // staged doubles per interval cell

struct alignas(16) PrepShared {
  double rec[PREP_TILE * PU_DOUBLES];  // P13 | packL | packR of the tile
  double lc[3];                        // log(covE), log(covH), log(covD)
};

// orders the block's shared-memory writes before its later reads; the
// host shims run each phase for all of a block's threads before the next
RD_FN void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

RD_FN long long prep_tiles(long long cells) {
  return (cells + PREP_TILE - 1) / PREP_TILE;
}

// rel-plane cell k (all-device layout)
RD_FN void prep_rel_cell(const Prep& a, long long k, double covEf,
                         double lce) {
  const long long UN = (long long)a.Bn * a.N;
  const long long RM2 = 2LL * a.R * a.M;
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
}

// scan row r2's own outputs (all-device layout)
RD_FN void prep_rel_row(const Prep& a, int r2) {
  const long long UN = (long long)a.Bn * a.N;
  const int R2 = 2 * a.R;
  const long long RM2 = (long long)R2 * a.M;
  const int* rows = a.iblob + 10 * UN + a.Bn + 5 * RM2
                    + (long long)a.R * a.M;     // m, plen, fwd
  prep_row(a, r2, RD_LDG(rows + r2), RD_LDG(rows + R2 + r2),
           RD_LDG(rows + 2 * R2 + r2) != 0);
}

// interval cell k, thread t of its tile: the P13 / packL / packR record
// into shared memory, the byte and int planes straight out.
// iblob: b, e, cb, ce, ccb, cce, idx_desc, idx_asc, is_rel, live
// [10 x Bn*max_n]; fblob: pe, peob, peoe, lf_cb, lf_ce [5 x Bn*max_n]
RD_FN void prep_un_cell(const Prep& a, long long k, int t,
                        PrepShared& sh) {
  const long long UN = (long long)a.Bn * a.N;
  const double b = (double)RD_LDG(a.iblob + k);
  const double e1 = (double)(RD_LDG(a.iblob + UN + k) - 1);
  const double cb = (double)RD_LDG(a.iblob + 2 * UN + k);
  const double ce = (double)RD_LDG(a.iblob + 3 * UN + k);
  const double lf_cb = RD_LDG(a.fblob + 3 * UN + k);
  const double lf_ce = RD_LDG(a.fblob + 4 * UN + k);
  const double covEf = (double)RD_LDG(a.gcov + ERR);
  const double covHf = (double)RD_LDG(a.gcov + HAP);
  const double covDf = (double)RD_LDG(a.gcov + DIP);
  const double lce = sh.lc[0], lch = sh.lc[1], lcd = sh.lc[2];
  double* p = sh.rec + P13_N * t;
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
  double* L = sh.rec + P13_N * PREP_TILE + 3 * t;
  L[0] = (double)RD_LDG(a.iblob + 5 * UN + k);
  L[1] = e1;
  L[2] = ce;
  double* Rr = sh.rec + (P13_N + 3) * PREP_TILE + 3 * t;
  Rr[0] = (double)RD_LDG(a.iblob + 4 * UN + k);
  Rr[1] = b;
  Rr[2] = cb;
  a.is_rel[k] = RD_LDG(a.iblob + 8 * UN + k) != 0;
  a.live[k] = RD_LDG(a.iblob + 9 * UN + k) != 0;
  a.asgn[k] = NST;
}

// dst[0, n) = src[0, n) (src in shared memory, 16-byte aligned), thread
// t's share of the block's stores
RD_FN void store_run(double* dst, const double* src, int n, int t) {
#ifdef __CUDA_ARCH__
  if (((unsigned long long)dst & 15) == 0) {
    const double2* s2 = (const double2*)src;
    double2* d2 = (double2*)dst;
    for (int i = t; i < n / 2; i += PREP_TILE) d2[i] = s2[i];
    if ((n & 1) && t == 0) dst[n - 1] = src[n - 1];
    return;
  }
#endif
  for (int i = t; i < n; i += PREP_TILE) dst[i] = src[i];
}

// Block ``blk`` of the all-device prep, threads t0 .. t0 + NT - 1 (one on
// the card; the whole block, phase by phase, in the host shim).
template <int NT>
RD_FN void prep_alldev_block(const Prep& a, long long blk, int t0,
                             PrepShared& sh) {
  const long long RM2 = 2LL * a.R * a.M;
  const long long UN = (long long)a.Bn * a.N;
  for (int t = t0; t < t0 + NT; ++t)
    if (t < 3)
      sh.lc[t] = log((double)RD_LDG(a.gcov + (t == 0 ? ERR : t + 1)));
  block_sync();
  const long long nrel = prep_tiles(RM2);
  if (blk < nrel) {
    const double covEf = (double)RD_LDG(a.gcov + ERR);
    for (int t = t0; t < t0 + NT; ++t) {
      const long long k = blk * PREP_TILE + t;
      if (k < RM2) prep_rel_cell(a, k, covEf, sh.lc[0]);
      if (k < 2LL * a.R) prep_rel_row(a, (int)k);
    }
    return;
  }
  const long long k0 = (blk - nrel) * PREP_TILE;
  const int cnt = (int)rd::mini(UN - k0, PREP_TILE);
  for (int t = t0; t < t0 + NT; ++t) {
    const long long k = k0 + t;
    if (t < cnt) prep_un_cell(a, k, t, sh);
    if (k < a.Bn) {
      a.gate[k] = a.gate_lo;
      a.gate[a.Bn + k] = a.gate_hi;
    }
  }
  block_sync();
  for (int t = t0; t < t0 + NT; ++t) {
    store_run(a.P13 + P13_N * k0, sh.rec, P13_N * cnt, t);
    store_run(a.packL + 3 * k0, sh.rec + P13_N * PREP_TILE, 3 * cnt, t);
    store_run(a.packR + 3 * k0, sh.rec + (P13_N + 3) * PREP_TILE, 3 * cnt,
              t);
  }
}

// ------------------------------------------------------ settle helpers

// IEEE division, as torch divides two f64 tensors
RD_FN double div_(double a, double b) { return a / b; }

// |p - 1| <= |q - 1| in the exact int64 form of the demotions: the mean
// csum / lsum nearer (or as near) gH than gD
RD_FN long long dist(long long csum, long long g, long long lsum) {
  return rd::wabs(rd::wsub(csum, rd::wmul(g, lsum)));
}

// -------------------------------------------------------------- settle
//
// A block of SETTLE_THREADS threads takes one read pair (rows j and
// R + j), the columns dealt over its threads (c = c0 + t; every thread
// runs every trip).  The whole chain per pair is latency: one pass from
// global memory, two block reductions, one pass over shared memory, four
// divisions, the scatter.
//   1. The per-row values (m, rescue, fwd, both margins of both rows, the
//      coverages) are loaded beside the pair's interval row, before the
//      padding pair's exit (the whole block leaves, before any barrier).
//   2. One pass from global memory caches the pair's rel_cols and both
//      rows' merged pass states in shared memory (the first SETTLE_CACHE
//      columns; with max_m beyond, the TAIL build reads the columns past
//      it from global memory again) and takes the sums of all three
//      demotion stages at once: per row the H, D and other counts within
//      m and the length and half-count sums over its H cells and its D
//      cells.  Stage 1 turns every D into H only when the row has no H,
//      so stage 2's non-H count and stage 3's H sums after stage 1 follow
//      from these; a row that stage 2 tests (all H after stage 1) has its
//      all-cell sums among them; stage 2 leaves no H within m, so stage 3
//      cannot fire after it.
//   3. One block reduction, then every thread decides the same stages; a
//      state after the stages is the cached state with its row's stage
//      flags applied, as alldev.demotes_dev applies them.
//   4. One pass over the cache for the reconciliation's minima (hdrr's
//      first and last D and H, the fw/bw difference, the fw row's first
//      and last zero and non-zero) in a second reduction; the pass also
//      caches each column's two scatter candidates.
//   5. hdrr's four divisions side by side in four lanes, then the
//      scatter of the candidate the reconciliation picks.
// The reductions are redux.sync warp reductions of 32-bit values (a
// wrapping int64 sum in three 22-bit pieces), then the four warps'
// partials through shared memory.

constexpr int SETTLE_THREADS = 128;
constexpr int SETTLE_WARPS = SETTLE_THREADS / WARP;
constexpr int SETTLE_CACHE = 4096;   // columns of a pair in shared memory
constexpr int NCNT = 6;              // counts (settle_load)
constexpr int NSUM = 8;              // int64 sums (settle_load)
constexpr int NEXT = 13;             // minima (settle_scan)

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

// the warps' partials of the block's reductions; the pair cache (int32
// rel_cols, both rows' int8 states and the scatter's candidates, of
// min(M, SETTLE_CACHE) columns each) is dynamic shared memory beside it
struct SettleShared {
  long long sums[SETTLE_WARPS * NSUM];
  int cnts[SETTLE_WARPS * NCNT];
  int ext[SETTLE_WARPS * NEXT];
};

RD_FN int settle_cache(int M) { return M < SETTLE_CACHE ? M : SETTLE_CACHE; }
RD_FN int settle_dyn_bytes(int M) { return 7 * settle_cache(M); }

// a load the compiler's front end keeps where it stands (not sunk below
// the padding pair's exit or into a later phase), so that the loads of a
// phase go out together
#ifdef __CUDA_ARCH__
RD_FN long long ld_now(const long long* p) {
  long long v;
  asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}
RD_FN double ld_now(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
RD_FN int ld_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
RD_FN int ld_now(const signed char* p) {
  int v;
  asm volatile("ld.global.nc.s8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
RD_FN int ld_now(const unsigned char* p) {
  int v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
#else
template <class T>
RD_FN T ld_now(const T* p) {
  return *p;
}
#endif

// one scan row, its per-row inputs and the demotion stages decided for it
struct Row {
  long long r, m;
  bool res, fwd, flip1, flip2, dem3;
  double mm1, mm2;
};

RD_FN Row row_of(const Settle& a, long long r) {
  Row d;
  d.r = r;
  d.m = ld_now(a.m + r);
  d.res = ld_now(a.rescue + r) != 0;
  d.fwd = ld_now(a.fwd + r) != 0;
  d.mm1 = ld_now(a.mm1 + r);
  d.mm2 = ld_now(a.mm2 + r);
  d.flip1 = d.flip2 = d.dem3 = false;
  return d;
}

// the row's state at column c of the pass it keeps (rel.merge_passes)
RD_FN int merged(const Settle& a, const Row& d, int c) {
  const long long i = d.r * a.M + c;
  const int v1 = ld_now(a.asgn1 + i), v2 = ld_now(a.asgn2 + i);
  return d.res ? v2 : v1;
}

// the pair cache: rel_cols of column c, the merged state of row h (0 fw,
// 1 bw) at column c, and column c's two candidates for the scatter (the
// fw row's state, the reversed bw row's, after the stages; 4 bits each)
struct Cache {
  int* cols;
  signed char* st;
  unsigned char* out;
  int C;
};

// (TAIL: max_m > SETTLE_CACHE, columns from C on are read from global
// memory; without it every column is cached and the passes read shared
// memory only)
template <bool TAIL>
RD_FN int base_at(const Settle& a, const Row& d, const Cache& k, int h,
                  int c) {
  if (TAIL && c >= k.C) return merged(a, d, c);
  return k.st[h * k.C + c];
}

// the state v at column c after the stages (alldev.demotes_dev): no-H
// rescue rows D -> H (every column), all-H rows H -> D, >= 70%-H rows
// H -> D and D -> R (columns < m)
RD_FN int staged(const Row& d, int v, int c) {
  if (d.flip1 && v == DIP) v = HAP;
  const bool inb = c < d.m;
  if (d.flip2 && inb && v == HAP) v = DIP;
  if (d.dem3 && inb) v = v == HAP ? DIP : (v == DIP ? REP : v);
  return v;
}

template <bool TAIL>
RD_FN int state(const Settle& a, const Row& d, const Cache& k, int h,
                int c) {
  return staged(d, base_at<TAIL>(a, d, k, h, c), c);
}

// column c of the forward order from its scan-order row: the reversal
// within m (padding columns keep their index)
RD_FN int flip_col(long long m, int c) {
  return c < m ? (int)(m - 1 - c) : c;
}

// thread t's columns of read pair j: cache rel_cols and both rows'
// merged states; per row h within m, n[3h ..] = the H, D and other
// counts, s[4h ..] = the length and half-count sums over the D cells and
// over the H cells (class_rel.c:650-713 read no more than these)
template <bool TAIL>
RD_FN void settle_load(const Settle& a, long long j, const Row (&d)[2],
                       int t, const Cache& k, int (&n)[NCNT],
                       long long (&s)[NSUM]) {
  RD_UNROLL
  for (int q = 0; q < NCNT; ++q) n[q] = 0;
  RD_UNROLL
  for (int q = 0; q < NSUM; ++q) s[q] = 0;
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += SETTLE_THREADS) {
    const int c = c0 + t;
    if (c >= a.M) continue;
    int v[2];
    long long bp[2], ep[2], bc[2], ec[2];
    RD_UNROLL
    for (int h = 0; h < 2; ++h) {
      const long long i = d[h].r * a.M + c;
      v[h] = merged(a, d[h], c);
      bp[h] = ld_now(a.bpos + i);
      ep[h] = ld_now(a.epos + i);
      bc[h] = ld_now(a.bcnt + i);
      ec[h] = ld_now(a.ecnt + i);
    }
    const int col = ld_now(a.rel_cols + j * a.M + c);
    if (!TAIL || c < k.C) {
      k.cols[c] = col;
      k.st[c] = (signed char)v[0];
      k.st[k.C + c] = (signed char)v[1];
    }
    RD_UNROLL
    for (int h = 0; h < 2; ++h) {
      if (c >= d[h].m) continue;
      const long long len = seg_len(bp[h], ep[h]);
      const long long half = seg_half(bc[h], ec[h], len);
      if (v[h] == HAP) {
        n[3 * h] += 1;
        s[4 * h + 2] = wadd(s[4 * h + 2], len);
        s[4 * h + 3] = wadd(s[4 * h + 3], half);
      } else if (v[h] == DIP) {
        n[3 * h + 1] += 1;
        s[4 * h] = wadd(s[4 * h], len);
        s[4 * h + 1] = wadd(s[4 * h + 1], half);
      } else {
        n[3 * h + 2] += 1;
      }
    }
  }
}

// the three demotion stages of a row from its counts and sums
// (settle_load)
RD_FN void decide(Row& d, const int* n, const long long* s, long long gH,
                  long long gD) {
  const int nH = n[0], nD = n[1], nO = n[2];
  const long long lsD = s[0], csD = s[1], lsH = s[2], csH = s[3];
  // stage 1 (class_rel.c:650-669); lsum == 0: C's 0.0/0 mean is NaN and
  // its compare false
  d.flip1 = d.res && nH == 0 && lsD > 0
            && dist(csD, gH, lsD) <= dist(csD, gD, lsD);
  // stage 2 (:674-690): rows all H after stage 1 (so their all-cell sums
  // are the H and D sums: one of the two is empty) nearer (or as near) gD
  const int nonh = d.flip1 ? nO : nO + nD;
  const long long la = wadd(lsH, lsD), ca = wadd(csH, csD);
  d.flip2 = nonh == 0 && dist(ca, gH, la) >= dist(ca, gD, la);
  // stage 3 (:692-713) on the H cells after stage 1 (>= 70% H, the
  // product in f64 as JAX takes it); none are left after stage 2
  const int n3 = d.flip1 ? nH + nD : nH;
  const long long l3 = d.flip1 ? la : lsH, c3 = d.flip1 ? ca : csH;
  d.dem3 = !d.flip2 && (double)n3 >= (double)d.m * 0.7 && l3 > 0
           && dist(c3, gH, l3) >= dist(c3, gD, l3);
}

// thread t's columns after the stages: e = per row (4h ..) the first D
// and H column and the negated last D and H column within m (hdrr); the
// negated fw/bw difference flag; the fw row's first and negated last zero
// and first and negated last non-zero column within m (is_eq_prefix /
// is_eq_suffix).  Minima all, so that one reduction takes them.  The
// cached columns' scatter candidates go to the cache.
template <bool TAIL>
RD_FN void settle_scan(const Settle& a, const Row (&d)[2], int t,
                       const Cache& k, int (&e)[NEXT]) {
  const int fm = (int)d[0].m;
  RD_UNROLL
  for (int h = 0; h < 2; ++h) {
    e[4 * h] = e[4 * h + 1] = a.M;
    e[4 * h + 2] = e[4 * h + 3] = 1;
  }
  e[8] = 0;
  e[9] = e[11] = fm;
  e[10] = e[12] = 1;
  GL_ROLLED
  for (int c0 = 0; c0 < a.M; c0 += SETTLE_THREADS) {
    const int c = c0 + t;
    if (c >= a.M) continue;
    int v[2];
    RD_UNROLL
    for (int h = 0; h < 2; ++h) {
      v[h] = state<TAIL>(a, d[h], k, h, c);
      if (c >= d[h].m) continue;
      if (v[h] == DIP) {
        e[4 * h] = rd::mini(e[4 * h], c);
        e[4 * h + 2] = rd::mini(e[4 * h + 2], -c);
      } else if (v[h] == HAP) {
        e[4 * h + 1] = rd::mini(e[4 * h + 1], c);
        e[4 * h + 3] = rd::mini(e[4 * h + 3], -c);
      }
    }
    const int vb = c < fm ? state<TAIL>(a, d[1], k, 1, flip_col(fm, c))
                          : v[1];
    if (!TAIL || c < k.C) k.out[c] = (unsigned char)(v[0] | vb << 4);
    if (c >= fm) continue;
    if (v[0] != vb) e[8] = -1;
    if (v[0] == 0) {
      e[9] = rd::mini(e[9], c);
      e[10] = rd::mini(e[10], -c);
    } else {
      e[11] = rd::mini(e[11], c);
      e[12] = rd::mini(e[12], -c);
    }
  }
}

// every lane gets the warp's total of v: a wrapping int64 sum (in three
// 22-bit pieces, each summed exactly in 32 bits: 32 x (2^22 - 1) < 2^27),
// an int sum, an int min
template <int NL>
RD_FN void warp_total(long long (&v)[NL]) {
#ifdef __CUDA_ARCH__
  const unsigned long long u = (unsigned long long)v[0];
  unsigned long long tot = 0;
  RD_UNROLL
  for (int q = 0; q < 3; ++q)
    tot += (unsigned long long)__reduce_add_sync(
               0xffffffffu, (unsigned)(u >> (22 * q)) & 0x3fffffu)
           << (22 * q);
  v[0] = (long long)tot;
#else
  long long tot = 0;
  for (int l = 0; l < NL; ++l) tot = wadd(tot, v[l]);
  for (int l = 0; l < NL; ++l) v[l] = tot;
#endif
}
template <bool MIN, int NL>
RD_FN void warp_total(int (&v)[NL]) {
#ifdef __CUDA_ARCH__
  v[0] = MIN ? __reduce_min_sync(0xffffffffu, v[0])
             : __reduce_add_sync(0xffffffffu, v[0]);
#else
  int tot = v[0];
  for (int l = 1; l < NL; ++l)
    tot = MIN ? (v[l] < tot ? v[l] : tot) : tot + v[l];
  for (int l = 0; l < NL; ++l) v[l] = tot;
#endif
}

// the warps' totals of v[t][k] over threads t0 .. t0 + NT - 1 into their
// slots of red (lane 0 writes), before a block_sync
template <bool MIN, int NT, class T, int K>
RD_FN void warp_partials(T (&v)[NT][K], int t0, T* red) {
  constexpr int NL = NT < WARP ? NT : WARP;   // 1 on the card, 32 shimmed
  for (int w0 = 0; w0 < NT; w0 += NL) {
    RD_UNROLL
    for (int k = 0; k < K; ++k) {
      T x[NL];
      for (int l = 0; l < NL; ++l) x[l] = v[w0 + l][k];
      if constexpr (sizeof(T) == 8)
        warp_total<NL>(x);
      else
        warp_total<MIN, NL>(x);
      if (((t0 + w0) & (WARP - 1)) == 0)
        red[(t0 + w0) / WARP * K + k] = x[0];
    }
  }
}

// the block's totals from the warps' partials, after a block_sync
template <bool MIN, class T, int K>
RD_FN void block_totals(const T* red, T (&out)[K]) {
  RD_UNROLL
  for (int k = 0; k < K; ++k) {
    T x = red[k];
    for (int w = 1; w < SETTLE_WARPS; ++w) {
      const T y = red[w * K + k];
      if constexpr (sizeof(T) == 8)
        x = wadd(x, y);
      else
        x = MIN ? (y < x ? y : x) : x + y;
    }
    out[k] = x;
  }
}

// both rows' hdrr (alldev.reconcile_dev) from their first D and H and
// last D and H columns (e as settle_scan's totals): entering counts over
// leaving counts (fw rows; the inverse on bw rows), 1.0 without both
// states.  The eight counts are read first, whatever the columns.  On the
// card each group of four lanes takes the four first divisions side by
// side, then two of them the two second ones (the division's slow-path
// test keeps one thread's divisions in series); the shim divides in turn,
// and an IEEE division gives the same bits in any lane.
RD_FN void hdrr(const Settle& a, const Row (&d)[2], const int (&e)[NEXT],
                int t, double (&out)[2]) {
  bool both[2];
  long long v[2][4];
  RD_UNROLL
  for (int h = 0; h < 2; ++h) {
    both[h] = e[4 * h] < a.M && e[4 * h + 1] < a.M;
    const long long o = d[h].r * a.M;
    const int* x = e + 4 * h;
    v[h][0] = ld_now(a.bcnt + o + (both[h] ? x[0] : 0));
    v[h][1] = ld_now(a.bcnt + o + (both[h] ? x[1] : 0));
    v[h][2] = ld_now(a.ecnt + o + (both[h] ? -x[2] : 0));
    v[h][3] = ld_now(a.ecnt + o + (both[h] ? -x[3] : 0));
  }
#ifdef __CUDA_ARCH__
  // lane q of a group: p (q even) or q (q odd) of row q >> 1
  const int q = t & 3, g = (t & (WARP - 1)) & ~3;
  const bool b = q >> 1, o = q & 1;
  const long long num = b ? (o ? v[1][2] : v[1][0]) : (o ? v[0][2] : v[0][0]);
  const long long den = b ? (o ? v[1][3] : v[1][1]) : (o ? v[0][3] : v[0][1]);
  const double r1 = div_((double)num, (double)den);
  double pq[4];
  RD_UNROLL
  for (int i = 0; i < 4; ++i) pq[i] = __shfl_sync(0xffffffffu, r1, g + i);
  // lanes 0 and 1 of a group (and 2, 3 again): row q & 1's hdrr
  const int h = q & 1;
  const double p = h ? pq[2] : pq[0], qq = h ? pq[3] : pq[1];
  const bool fw = h ? d[1].fwd : d[0].fwd;
  const double r2 = fw ? div_(p, qq) : div_(qq, p);
  const double hd[2] = {__shfl_sync(0xffffffffu, r2, g),
                        __shfl_sync(0xffffffffu, r2, g + 1)};
#else
  (void)t;
  double hd[2];
  for (int h = 0; h < 2; ++h) {
    const double p = div_((double)v[h][0], (double)v[h][1]);
    const double qq = div_((double)v[h][2], (double)v[h][3]);
    hd[h] = d[h].fwd ? div_(p, qq) : div_(qq, p);
  }
#endif
  out[0] = both[0] ? hd[0] : 1.0;
  out[1] = both[1] ? hd[1] : 1.0;
}

// alldev.settle_ref for read pair j (rows j and R + j), threads t0 ..
// t0 + NT - 1 of its block (one on the card; the whole block, phase by
// phase, in the host shim): merge the passes, demote both rows,
// reconcile them (class_rel.c:847-938), write the reconciled row into
// the sweeps' assignments at (rel_rows[j], rel_cols[j, c]) (sentinel rows
// and columns dropped) and open the read's margin gate when either row's
// margin is risky.  ``dyn`` is the block's pair cache
// (settle_dyn_bytes(M) bytes).
template <int NT, bool TAIL>
RD_FN void settle_block(const Settle& a, long long j, int t0,
                        SettleShared& sh, unsigned char* dyn) {
  RD_CLOCKS;   // thread 0's cycles by part (-DRD_PHASE_CLOCKS builds only)
  RD_MARK(0);
  const long long x = ld_now(a.rel_rows + j);
  Row d[2] = {row_of(a, j), row_of(a, a.R + j)};
  const long long gH = ld_now(a.gcov + HAP), gD = ld_now(a.gcov + DIP);
  if (x < 0 || x >= a.Bn) return;   // a padding pair: the whole block
  Cache k;
  k.C = settle_cache(a.M);
  k.cols = (int*)dyn;
  k.st = (signed char*)(dyn + 4 * k.C);
  k.out = dyn + 6 * k.C;

  int n[NT][NCNT], nt[NCNT];
  long long s[NT][NSUM], st[NSUM];
  for (int t = 0; t < NT; ++t)
    settle_load<TAIL>(a, j, d, t0 + t, k, n[t], s[t]);
  RD_MARK(1);
  warp_partials<false, NT>(n, t0, sh.cnts);
  warp_partials<false, NT>(s, t0, sh.sums);
  block_sync();
  block_totals<false>(sh.cnts, nt);
  block_totals<false>(sh.sums, st);
  RD_MARK(2);
  decide(d[0], nt, st, gH, gD);
  decide(d[1], nt + 3, st + 4, gH, gD);
  const int fm = (int)d[0].m;
  const int first = state<TAIL>(a, d[0], k, 0, 0);
  const int last = state<TAIL>(a, d[0], k, 0, fm > 0 ? fm - 1 : 0);
  RD_MARK(3);

  int e[NT][NEXT], ext[NEXT];
  for (int t = 0; t < NT; ++t) settle_scan<TAIL>(a, d, t0 + t, k, e[t]);
  RD_MARK(4);
  warp_partials<true, NT>(e, t0, sh.ext);
  block_sync();
  block_totals<true>(sh.ext, ext);
  RD_MARK(5);
  double hd[2];
  hdrr(a, d, ext, t0, hd);
  const bool neq = ext[8] != 0;
  const int fz = ext[9], lz = -ext[10];     // first / last zero
  const int fnz = ext[11], lnz = -ext[12];  // first / last non-zero
  // a non-zero state at or after the first zero, in the row and in its
  // reversal within m
  const bool nz = fz < fm && lnz >= fz;
  const bool nzr = lz >= 0 && fnz <= lz;
  const bool is_prefix = first == REP && !nz;
  const bool is_suffix = last == REP && !nzr;
  const bool keep_f = fabs(hd[0] - 1.0) <= fabs(hd[1] - 1.0);
  const bool take_b = neq && !is_prefix && (is_suffix || !keep_f);
  RD_MARK(6);

  for (int t = t0; t < t0 + NT; ++t) {
    GL_ROLLED
    for (int c0 = 0; c0 < a.M; c0 += SETTLE_THREADS) {
      const int c = c0 + t;
      if (c >= a.M) continue;
      int col, vf, vb;
      if (!TAIL || c < k.C) {
        col = k.cols[c];
        vf = k.out[c] & 15;
        vb = k.out[c] >> 4;
      } else {
        col = RD_LDG(a.rel_cols + j * a.M + c);
        vf = state<TAIL>(a, d[0], k, 0, c);
        vb = state<TAIL>(a, d[1], k, 1, flip_col(fm, c));
      }
      if (col < 0 || col >= a.N) continue;
      a.asgn[x * a.N + col] = take_b ? vb : vf;
    }
    if (t == 0
        && (risky(d[0].res ? tmin(d[0].mm1, d[0].mm2) : d[0].mm1)
            || risky(d[1].res ? tmin(d[1].mm1, d[1].mm2) : d[1].mm1))) {
      a.gate[x] = -RD_INF;
      a.gate[a.Bn + x] = RD_INF;
    }
  }
  RD_MARK(7);
  RD_ADD_STEP;
  RD_FLUSH(t0 == 0, 1);
}

// the block body for this launch's max_m (one test, the same in every
// thread of the grid)
template <int NT>
RD_FN void settle_pair(const Settle& a, long long j, int t0,
                       SettleShared& sh, unsigned char* dyn) {
  if (a.M > SETTLE_CACHE)
    settle_block<NT, true>(a, j, t0, sh, dyn);
  else
    settle_block<NT, false>(a, j, t0, sh, dyn);
}

}  // namespace gl
