// Reliable-interval Viterbi DP (K1), its inlined log-Skellam lookup (K2)
// and the traceback (K3) as one kernel for sm_90a, bound with ctypes.
//
// Replaces the JAX package's rel_dev2.rel_dp_pass2 (rel_dev2.py:636-787)
// with skellam_dev.skellam_args/skellam_value (skellam_dev.py:284-323);
// the per-row body is rel_dp_row.cuh.
//
// Design: one thread per DP row (read x scan direction), each running its
// own m-1 steps and then its traceback.  What bounds it on the card: a
// row's steps are a dependent chain (step i reads step i-1's cell), and
// each step's two Skellam lookups are 40-byte gathers from a 94.6 MB
// table (larger than the 50 MB L2), so the time is the chain's latency
// times the longest row, not bytes or flops; with ~512 rows per chunk the
// card runs a few warps.  This first version keeps the per-cell path
// registers (4 x 16 int64 + 4 x 6 bool per thread) in local memory and
// makes no attempt to hide that latency.
//
// Build (see kernels.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC.
// Under g++ -x c++ (no __CUDACC__) the same file compiles to the host
// test shim, which runs the rows in a loop.

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

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void rel_dp_kernel(rd::Args a) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.R2) rd::row(a, b);
}

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int rel_dp_launch(RD_ARGS_DECL, void* stream) {
  rd::Args a = rd_make_args(RD_ARGS_PASS);
  const int threads = 64;
  const int blocks = (R2 + threads - 1) / threads;
  if (blocks > 0)
    rel_dp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#else

// Host test shim: the same per-row body, rows in a loop.
extern "C" int rel_dp_host(RD_ARGS_DECL) {
  rd::Args a = rd_make_args(RD_ARGS_PASS);
  for (int b = 0; b < R2; ++b) rd::row(a, b);
  return 0;
}

#endif
