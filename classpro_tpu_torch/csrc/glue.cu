// The all-device path's per-chunk glue around the DP kernel (K4) and
// around the sweep kernel (K6) as two kernels for sm_90a, bound with
// ctypes:
//   rel_prep   the DP's and the sweeps' planes from a chunk's blobs (the
//              all-device layout);
//   rel_settle the pass merge, demotions, fw/bw reconciliation, the
//              scatter into the sweeps' assignments and the read's rel
//              flag (all-device path), one block per read pair.
// Replaces the JAX package's device_pipeline._rel_only_core :541,
// _rel_pipeline :153, _unpack :119, _demotes_dev :257,
// _reconcile_dev :401, _un_planes :511 and classify_batch_dev's tail
// :686-704, which XLA fused into one program per chunk.  The bodies are
// glue_row.cuh.  The rest of K4 runs inside the DP kernel (rel_dp.cu):
// the main layout's planes as its first pass's prologue (prep_cell.cuh),
// the rescue predicate and the pack as its row tails (rel_tail.cuh); as
// kernels of their own they cost a launch each for a few operations per
// cell.
//
// What bounds them on the card: bytes.  A chunk's glue reads its blobs
// and writes the DP's and the sweeps' planes once, a few MB to some 17 MB
// at the medium shapes, a few microseconds at 3.35 TB/s; the work per
// byte is a handful of integer and f64 operations.  So the design counts
// launches (one per program stage between the DP and sweep launches) and
// store transactions:
//   - rel_prep: a block per tile of 256 cells; the interval tiles stage
//     their 13-double P13 and 3-double packL / packR records in shared
//     memory (38.9 KB) and write each as one contiguous run of 16-byte
//     stores, where one thread per cell would scatter every store over
//     32 records; the coverages' logs once per block; no 64-bit
//     division.
//   - rel_settle: a block of 128 threads per read pair, so that a chunk's
//     200-256 pairs fill the card (one warp per pair would leave one or
//     two warps per SM, nothing to hide a load); the pair's rel_cols and
//     both rows' states are loaded once into shared memory (7 bytes a
//     column; beyond 4096 columns read again from global memory) with the
//     sums of all three demotion stages, and the stages, the
//     reconciliation and the scatter run on that cache with two block
//     reductions (redux.sync) in all.  Its time is a chain of latencies
//     per pair, not bytes.

// Build (see kernels.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC.
// Under g++ -x c++ (no __CUDACC__) the same file compiles to the host
// test shims, which run each warp's 32 lanes, or each block's threads,
// phase by phase.

#include "glue_row.cuh"

#define GP_ARGS_DECL                                                       \
  const void *iblob, const void *fblob, const void *logfact,              \
      const void *gcov, double e_po_base, int R, int M, int Bn, int N,     \
      double gate_lo, double gate_hi, void *bpos, void *bcnt, void *epos,  \
      void *ecnt, void *max_cc, void *m, void *plen, void *cov,            \
      void *logpE, void *fwd, void *is_rel, void *live, void *asgn,        \
      void *P13, void *packL, void *packR, void *gate
#define GP_ARGS_PASS                                                      \
  iblob, fblob, logfact, gcov, e_po_base, R, M, Bn, N, gate_lo, gate_hi,  \
      bpos, bcnt, epos, ecnt, max_cc, m, plen, cov, logpE, fwd, is_rel,   \
      live, asgn, P13, packL, packR, gate

static gl::Prep gp_make_args(GP_ARGS_DECL) {
  gl::Prep a;
  a.iblob = (const int*)iblob;
  a.fblob = (const double*)fblob;
  a.logfact = (const double*)logfact;
  a.gcov = (const long long*)gcov;
  a.e_po_base = e_po_base;
  a.R = R;
  a.M = M;
  a.Bn = Bn;
  a.N = N;
  a.gate_lo = gate_lo;
  a.gate_hi = gate_hi;
  a.bpos = (long long*)bpos;
  a.bcnt = (long long*)bcnt;
  a.epos = (long long*)epos;
  a.ecnt = (long long*)ecnt;
  a.max_cc = (long long*)max_cc;
  a.m = (long long*)m;
  a.plen = (long long*)plen;
  a.cov = (long long*)cov;
  a.logpE = (double*)logpE;
  a.fwd = (unsigned char*)fwd;
  a.is_rel = (unsigned char*)is_rel;
  a.live = (unsigned char*)live;
  a.asgn = (int*)asgn;
  a.P13 = (double*)P13;
  a.packL = (double*)packL;
  a.packR = (double*)packR;
  a.gate = (double*)gate;
  return a;
}

#define GS_ARGS_DECL                                                       \
  const void *asgn1, const void *asgn2, const void *mm1, const void *mm2,  \
      const void *rescue, const void *bpos, const void *bcnt,              \
      const void *epos, const void *ecnt, const void *m, const void *fwd,  \
      const void *rel_rows, const void *rel_cols, const void *gcov, int R, \
      int M, int Bn, int N, void *asgn, void *gate
#define GS_ARGS_PASS                                                      \
  asgn1, asgn2, mm1, mm2, rescue, bpos, bcnt, epos, ecnt, m, fwd,         \
      rel_rows, rel_cols, gcov, R, M, Bn, N, asgn, gate

static gl::Settle gs_make_args(GS_ARGS_DECL) {
  gl::Settle a;
  a.asgn1 = (const signed char*)asgn1;
  a.asgn2 = (const signed char*)asgn2;
  a.mm1 = (const double*)mm1;
  a.mm2 = (const double*)mm2;
  a.rescue = (const unsigned char*)rescue;
  a.bpos = (const long long*)bpos;
  a.bcnt = (const long long*)bcnt;
  a.epos = (const long long*)epos;
  a.ecnt = (const long long*)ecnt;
  a.m = (const long long*)m;
  a.fwd = (const unsigned char*)fwd;
  a.rel_rows = (const int*)rel_rows;
  a.rel_cols = (const int*)rel_cols;
  a.gcov = (const long long*)gcov;
  a.R = R;
  a.M = M;
  a.Bn = Bn;
  a.N = N;
  a.asgn = (int*)asgn;
  a.gate = (double*)gate;
  return a;
}

// Launch geometry: rel_prep one block per tile of gl::PREP_TILE cells
// (the rel planes' tiles, then the interval planes'), its records staged
// in static shared memory; rel_settle one block of gl::SETTLE_THREADS per
// read pair, its row cache in dynamic shared memory.
static long long gl_prep_blocks(long long rel_cells, long long un_cells) {
  return gl::prep_tiles(rel_cells) + gl::prep_tiles(un_cells);
}

// out[0..2] = threads per block, blocks and shared bytes per block (static
// and dynamic) of a launch of ``kernel``: 0 rel_prep over n rel-plane and
// n2 interval cells, 1 rel_settle over n read pairs of max_m n2.
extern "C" int glue_geometry(int kernel, long long n, long long n2,
                             int* out) {
  switch (kernel) {
    case 0:
      out[0] = gl::PREP_TILE;
      out[1] = (int)gl_prep_blocks(n, n2);
      out[2] = (int)sizeof(gl::PrepShared);
      return 0;
    case 1:
      out[0] = gl::SETTLE_THREADS;
      out[1] = (int)n;
      out[2] = (int)sizeof(gl::SettleShared) + gl::settle_dyn_bytes((int)n2);
      return 0;
  }
  return 1;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void __launch_bounds__(gl::PREP_TILE)
rel_prep_alldev_kernel(gl::Prep a) {
  __shared__ gl::PrepShared sh;
  gl::prep_alldev_block<1>(a, blockIdx.x, threadIdx.x, sh);
}

__global__ void __launch_bounds__(gl::SETTLE_THREADS)
rel_settle_kernel(gl::Settle a) {
  __shared__ gl::SettleShared sh;
  extern __shared__ __align__(16) unsigned char dyn[];
  gl::settle_pair<1>(a, blockIdx.x, threadIdx.x, sh, dyn);
}

// Launches on ``stream``; each returns cudaGetLastError() (0 = launched).
extern "C" int rel_prep_launch(GP_ARGS_DECL, void* stream) {
  const gl::Prep a = gp_make_args(GP_ARGS_PASS);
  const long long blocks = gl_prep_blocks(2LL * a.R * a.M,
                                          (long long)a.Bn * a.N);
  if (blocks > 0)
    rel_prep_alldev_kernel<<<(unsigned)blocks, gl::PREP_TILE, 0,
                             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int rel_settle_launch(GS_ARGS_DECL, void* stream) {
  if (R > 0)
    rel_settle_kernel<<<R, gl::SETTLE_THREADS, gl::settle_dyn_bytes(M),
                        (cudaStream_t)stream>>>(gs_make_args(GS_ARGS_PASS));
  return (int)cudaGetLastError();
}

// rel_settle's part clocks (a -DRD_PHASE_CLOCKS build: chip_smoke.py
// --phases settleprofile): out[0..7] = the sums of thread 0's cycles by
// part over the read pairs, then the pairs; reset zeroes them.
#ifdef RD_PHASE_CLOCKS
extern "C" int rel_settle_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[rd::NPART + 1] = {0};
    return (int)cudaMemcpyToSymbol(rd::rd_phase_clocks, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, rd::rd_phase_clocks,
                                   (rd::NPART + 1) * sizeof(unsigned long long));
}
#endif

#else

#include <vector>

// Host test shims: the same bodies, a block with all its threads, phase
// by phase.
extern "C" int rel_prep_host(GP_ARGS_DECL) {
  const gl::Prep a = gp_make_args(GP_ARGS_PASS);
  gl::PrepShared sh;
  const long long nb = gl_prep_blocks(2LL * a.R * a.M, (long long)a.Bn * a.N);
  for (long long b = 0; b < nb; ++b)
    gl::prep_alldev_block<gl::PREP_TILE>(a, b, 0, sh);
  return 0;
}

extern "C" int rel_settle_host(GS_ARGS_DECL) {
  const gl::Settle a = gs_make_args(GS_ARGS_PASS);
  gl::SettleShared sh;
  std::vector<int> dyn((gl::settle_dyn_bytes(M) + 3) / 4);
  for (long long j = 0; j < R; ++j)
    gl::settle_pair<gl::SETTLE_THREADS>(a, j, 0, sh,
                                        (unsigned char*)dyn.data());
  return 0;
}

#endif
