// Reliable-interval Viterbi DP (K1), its inlined log-Skellam lookup (K2)
// and the traceback (K3) as one kernel for sm_90a, bound with ctypes.
//
// Replaces the JAX package's rel_dev2.rel_dp_pass2 (rel_dev2.py:636-787)
// with skellam_dev.skellam_args/skellam_value (skellam_dev.py:284-323);
// the row body is rel_dp_row.cuh, the shared arithmetic rd_math.cuh.
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
      void *bp, void *rpos, int R2, int max_m, const void *tab,            \
      const void *lf_small, int n1, double read_len, long long offset,     \
      double r_logp, double log_1m_pe_mean, double log_pe_mean,            \
      double dr_ratio

static rd::Args rd_make_args(RD_ARGS_DECL) {
  rd::Args a;
  a.bpos = (const long long*)bpos;
  a.bcnt = (const long long*)bcnt;
  a.epos = (const long long*)epos;
  a.ecnt = (const long long*)ecnt;
  a.max_cc = (const long long*)max_cc;
  a.lf_bcnt = (const double*)lf_bcnt;
  a.logpE = (const double*)logpE;
  a.m = (const long long*)m;
  a.plen = (const long long*)plen;
  a.fwd = (const unsigned char*)fwd;
  a.cov = (const long long*)cov;
  a.active = (const unsigned char*)active;
  a.asgn = (signed char*)asgn;
  a.dp_out = (double*)dp_out;
  a.mm_out = (double*)mm_out;
  a.bp = (signed char*)bp;
  a.rpos = (unsigned char*)rpos;
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
      active, asgn, dp_out, mm_out, bp, rpos, R2, max_m, tab, lf_small,   \
      n1, read_len, offset, r_logp, log_1m_pe_mean, log_pe_mean, dr_ratio

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

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void __launch_bounds__(RD_THREADS)
rel_dp_kernel(rd::Args a, int use_smem) {
  extern __shared__ unsigned char rd_smem[];
  rd::Scratch scr{a.bp, a.rpos, 0};
  if (use_smem) {
    const int M = a.max_m;
    scr.bp = (signed char*)rd_smem;
    scr.rpos = rd_smem + (long long)RD_ROWS_PER_BLOCK * (M - 1) * 4;
    scr.row0 = blockIdx.x * RD_ROWS_PER_BLOCK;
  }
  rd::warp_rows<1>(a, blockIdx.x * blockDim.x + threadIdx.x, scr);
}

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rel_dp_launch(RD_ARGS_DECL, void* stream) {
  rd::Args a = rd_make_args(RD_ARGS_PASS);
  int geo[5];
  rel_dp_geometry(R2, max_m, geo);
  if (geo[3] > 0)
    rel_dp_kernel<<<geo[3], RD_THREADS, geo[4], (cudaStream_t)stream>>>(
        a, geo[4] > 0);
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
// the warps of the launch; the global scratch holds the backpointers.
extern "C" int rel_dp_host(RD_ARGS_DECL) {
  rd::Args a = rd_make_args(RD_ARGS_PASS);
  const rd::Scratch scr{a.bp, a.rpos, 0};
  const int lanes = rd_blocks(R2) * RD_THREADS;
  for (int g0 = 0; g0 < lanes; g0 += rd::WARP) rd::warp_rows<rd::WARP>(a, g0, scr);
  return 0;
}

#endif
