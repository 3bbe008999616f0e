// Reliable-interval Viterbi DP (K1), its inlined log-Skellam lookup (K2)
// and the traceback (K3) as one kernel for sm_90a, bound with ctypes,
// with an optional prologue (the main path's first pass: the planes from
// the chunk's blobs, rel_dp_first_kernel) and two optional row tails: the
// no-H rescue predicate (on the first pass) and the packed result (on
// both passes of the main path), so that a main-path chunk is two
// launches of this kernel.
//
// Replaces the JAX package's rel_dev2.rel_dp_pass2 (rel_dev2.py:636-787)
// with skellam_dev.skellam_args/skellam_value (skellam_dev.py:284-323),
// in its prologue device_pipeline._rel_only_core (:572-626) with the E
// emission of _rel_pipeline (:170-174), and in its tails
// device_pipeline._rel_pipeline's rescue predicate and pass merge
// (device_pipeline.py:198-241) and _pack_out (:638-651); the row body is
// rel_dp_row.cuh, the prologue's cell prep_cell.cuh, the tails' cells and
// rows rel_tail.cuh, the shared arithmetic rd_math.cuh.
//
// Design: eight lanes per DP row (read x scan direction) in two mirrored
// groups of four, lane c of each group holding DP cell c and its path
// registers in registers; four rows share a warp and a block is one warp,
// so a 512-row chunk runs as 128 blocks on 128 of the 132 SMs.  A step is
// three phases with shuffle rounds between them (rel_dp_row.cuh): each
// lane's half of its cell's terms (one Skellam lookup, and the cell's
// update of the H or D target were it their predecessor), the decisions,
// split so that lane c works on row c and on target column c, and lane
// c's update of its cell from the registers of its selected predecessor.
// The plane values of step i+1 are loaded while step i runs.  The
// backpointers and only_r flags live in shared memory while a block's
// rows fit in 48 KB (max_m <= 2458), in the global scratch beyond, and
// one lane per row runs the traceback.
//
// This replaces the first version's one thread per row: 7-8 blocks of 2
// warps per chunk, the 4 x 16 int64 path registers in a 752-byte local
// stack copied through a runtime index every step, and the step's eight
// Skellam lookups one after another on one thread.
//
// What bounds it on the card: a row is still a dependent chain of m-1
// steps, one warp per SM, so a step costs the latency of its longest lane
// chain, not bytes or flops.  Phase A is the largest part (PERF.md): the
// lookup's IEEE divisions, sqrt, floor and log around its 40-byte table
// gather, then the candidate update's three divisions; every division
// carries a slow-path branch, so independent chains on one lane do not
// interleave.  Then phase B's serial f64 compare-select chains and the
// shuffle rounds.  Left for later: computing step i+1's lookups for each
// of the four possible predecessors while step i decides (32 lanes per
// row), and shorter compare chains in phase B.
//
// The tails replace two glue kernels of one warp per row whose bodies
// were a few operations per cell but which cost a launch each (~3 and
// ~2 us in a CUDA graph, and a wrapper call of Python on the host).  A
// row's tails need only that row's assignments, just written by its
// traceback, so they run in the epilogue, when the step loop's registers
// are dead: the row's eight lanes deal its columns, a three-round shuffle
// reduction gives each lane the row's sums, and the row's lanes write its
// packed bytes.
//
// The prologue replaces the main layout of the glue kernel rel_prep (one
// thread per cell, ~3 us in a CUDA graph for 4.5 MB, a launch's cost and
// a wrapper call): a row's planes depend only on its own blob row, so
// the row's eight lanes write them before the step loop, which then
// loads them with plain loads (this launch wrote them; the read-only
// path may be stale), as do the tails.  Two entry functions, one per
// instantiation of the row body: rel_dp_first_kernel (prologue, plain
// loads) and rel_dp_kernel (planes from another launch, __ldg).

// Build (see kernels.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC.
// Under g++ -x c++ (no __CUDACC__) the same file compiles to the host
// test shim, which runs each warp's 32 lanes phase by phase.

#include "rel_dp_row.cuh"

#define RD_ARGS_DECL                                                       \
  const void *bpos, const void *bcnt, const void *epos, const void *ecnt,  \
      const void *max_cc, const void *lf_bcnt, const void *logpE,          \
      const void *m, const void *plen, const void *fwd, const void *cov,   \
      const void *active, void *asgn, void *dp_out, void *mm_out,          \
      void *bp, void *rpos, void *rescue, void *cov2, const void *gcov,    \
      void *packed, const void *mm_prev, const void *iblob,                \
      const void *fblob, const void *logfact, double e_po_base, int R2,    \
      int max_m, const void *tab, const void *lf_small, int n1,            \
      double read_len, long long offset, double r_logp,                    \
      double log_1m_pe_mean, double log_pe_mean, double dr_ratio

static rd::Args rd_make_args(RD_ARGS_DECL) {
  rd::Args a;
  // the planes: written by the prologue where iblob is given
  a.bpos = (long long*)bpos;
  a.bcnt = (long long*)bcnt;
  a.epos = (long long*)epos;
  a.ecnt = (long long*)ecnt;
  a.max_cc = (long long*)max_cc;
  a.lf_bcnt = (double*)lf_bcnt;
  a.logpE = (double*)logpE;
  a.m = (long long*)m;
  a.plen = (long long*)plen;
  a.fwd = (unsigned char*)fwd;
  a.cov = (long long*)cov;
  a.active = (const unsigned char*)active;
  a.asgn = (signed char*)asgn;
  a.dp_out = (double*)dp_out;
  a.mm_out = (double*)mm_out;
  a.bp = (signed char*)bp;
  a.rpos = (unsigned char*)rpos;
  a.rescue = (unsigned char*)rescue;
  a.cov2 = (long long*)cov2;
  a.gcov = (const long long*)gcov;
  a.packed = (unsigned char*)packed;
  a.mm_prev = (const double*)mm_prev;
  a.blob.iblob = (const int*)iblob;
  a.blob.fblob = (const double*)fblob;
  a.blob.logfact = (const double*)logfact;
  a.blob.e_po_base = e_po_base;
  a.R2 = R2;
  a.max_m = max_m;
  a.P.tab = (const double*)tab;
  a.P.lf_small = (const double*)lf_small;
  a.P.n1 = n1;
  a.P.read_len = read_len;
  a.P.offset = offset;
  a.P.r_logp = r_logp;
  a.P.log_1m_pe_mean = log_1m_pe_mean;
  a.P.log_pe_mean = log_pe_mean;
  a.P.dr_ratio = dr_ratio;
  return a;
}

#define RD_ARGS_PASS                                                      \
  bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd, cov,      \
      active, asgn, dp_out, mm_out, bp, rpos, rescue, cov2, gcov, packed, \
      mm_prev, iblob, fblob, logfact, e_po_base, R2, max_m, tab,          \
      lf_small, n1, read_len, offset, r_logp, log_1m_pe_mean, log_pe_mean, \
      dr_ratio

// Launch geometry: one warp per block, ROWS_PER_WARP rows per block.
constexpr int RD_THREADS = rd::WARP;
constexpr int RD_ROWS_PER_BLOCK = RD_THREADS / rd::LANES;
constexpr int RD_SMEM_MAX = 48 * 1024;

static int rd_blocks(int R2) {
  return (R2 + RD_ROWS_PER_BLOCK - 1) / RD_ROWS_PER_BLOCK;
}
// shared bytes a block needs for its rows' backpointers and only_r flags
static long long rd_smem_bytes(int max_m) {
  return (long long)RD_ROWS_PER_BLOCK * ((long long)(max_m - 1) * 4 + max_m);
}

// out[0..5] = lanes per row, rows per warp, threads per block, blocks,
// shared bytes per block (0: the global scratch) for (R2, max_m).
extern "C" int rel_dp_geometry(int R2, int max_m, int* out) {
  const long long sm = rd_smem_bytes(max_m);
  out[0] = rd::LANES;
  out[1] = rd::ROWS_PER_WARP;
  out[2] = RD_THREADS;
  out[3] = rd_blocks(R2);
  out[4] = sm <= RD_SMEM_MAX ? (int)sm : 0;
  return 0;
}

// The pack tail's five bytes of rows whose margins are given
// (gl::row_tail_byte: the first pass's where mm_prev is null, else the
// rescue pass's), row i into out[5i .. 5i+4]: the check of the margin
// merge and the f32 conversion on margins no DP pass gives (NaN, -0,
// subnormals).  No path runs it.
RD_FN void rd_tail_probe_row(const double* mm_prev, const double* mm,
                              long long i, unsigned char* out) {
  for (int k = 0; k < 5; ++k)
    out[5 * i + k] = gl::row_tail_byte(k, mm_prev, i, mm[i]);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void rel_tail_probe_kernel(const double* mm_prev,
                                      const double* mm, int n,
                                      unsigned char* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) rd_tail_probe_row(mm_prev, mm, i, out);
}

extern "C" int rel_tail_probe_launch(const void* mm_prev, const void* mm,
                                     int n, void* out, void* stream) {
  if (n > 0)
    rel_tail_probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const double*)mm_prev, (const double*)mm, n, (unsigned char*)out);
  return (int)cudaGetLastError();
}

extern __shared__ unsigned char rd_smem[];

template <bool PRO>
__device__ __forceinline__ void rel_dp_block(const rd::Args& a,
                                             int use_smem) {
  rd::Scratch scr{a.bp, a.rpos, 0};
  if (use_smem) {
    const int M = a.max_m;
    scr.bp = (signed char*)rd_smem;
    scr.rpos = rd_smem + (long long)RD_ROWS_PER_BLOCK * (M - 1) * 4;
    scr.row0 = blockIdx.x * RD_ROWS_PER_BLOCK;
  }
  rd::warp_rows<1, PRO>(a, blockIdx.x * blockDim.x + threadIdx.x, scr);
}

// the planes from another launch
__global__ void __launch_bounds__(RD_THREADS)
rel_dp_kernel(rd::Args a, int use_smem) {
  rel_dp_block<false>(a, use_smem);
}

// the main path's first pass: the planes from the blobs (prologue)
__global__ void __launch_bounds__(RD_THREADS)
rel_dp_first_kernel(rd::Args a, int use_smem) {
  rel_dp_block<true>(a, use_smem);
}

// Launch on ``stream`` (rel_dp_first_kernel where iblob is given);
// returns cudaGetLastError() (0 = launched).
extern "C" int rel_dp_launch(RD_ARGS_DECL, void* stream) {
  rd::Args a = rd_make_args(RD_ARGS_PASS);
  int geo[5];
  rel_dp_geometry(R2, max_m, geo);
  if (geo[3] > 0) {
    if (iblob)
      rel_dp_first_kernel<<<geo[3], RD_THREADS, geo[4],
                            (cudaStream_t)stream>>>(a, geo[4] > 0);
    else
      rel_dp_kernel<<<geo[3], RD_THREADS, geo[4], (cudaStream_t)stream>>>(
          a, geo[4] > 0);
  }
  return (int)cudaGetLastError();
}

#ifdef RD_PHASE_CLOCKS
// The phase clocks' sums (rel_dp_row.cuh), and their reset.
extern "C" int rel_dp_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[rd::NPART + 1] = {0};
    return (int)cudaMemcpyToSymbol(rd::rd_phase_clocks, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, rd::rd_phase_clocks,
                                   (rd::NPART + 1) * sizeof(unsigned long long));
}
#endif

#else

// Host test shim: the same warp body, one warp's 32 lanes per call, over
// the warps of the launch (the prologue a phase of its own where iblob is
// given); the global scratch holds the backpointers.
extern "C" int rel_dp_host(RD_ARGS_DECL) {
  rd::Args a = rd_make_args(RD_ARGS_PASS);
  const rd::Scratch scr{a.bp, a.rpos, 0};
  const int lanes = rd_blocks(R2) * RD_THREADS;
  for (int g0 = 0; g0 < lanes; g0 += rd::WARP) {
    if (iblob)
      rd::warp_rows<rd::WARP, true>(a, g0, scr);
    else
      rd::warp_rows<rd::WARP, false>(a, g0, scr);
  }
  return 0;
}

extern "C" int rel_tail_probe_host(const void* mm_prev, const void* mm,
                                   int n, void* out) {
  for (long long i = 0; i < n; ++i)
    rd_tail_probe_row((const double*)mm_prev, (const double*)mm, i,
                      (unsigned char*)out);
  return 0;
}

#endif
