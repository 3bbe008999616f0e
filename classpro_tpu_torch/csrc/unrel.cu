// The two relaxation sweeps (K5) as one kernel for sm_90a, bound with
// ctypes.
//
// Replaces the JAX package's unrel_dev2.unrel_sweeps2 (unrel_dev2.py:67)
// and _unrel_lane's step_fn (:157-279), with the log-Skellam lookup of
// skellam_dev.logp_skellam_packed (:326) inlined as rd::skellam; the
// per-row body is unrel_row.cuh.
//
// Design: one thread per read row, running the descending sweep and then
// the ascending one over the row's live steps; the row's working
// assignment is its output row in global memory (thread-private).  What
// bounds it on the card: each step depends on the assignments the earlier
// steps wrote, so a row is a dependent chain of 2 x n steps, and each step
// scans outward for its nearest reliable H/D neighbours (O(n) reads), so a
// row costs O(n^2) dependent loads; a chunk of 200 reads fills two blocks
// of the 132-SM card.  Time is the longest row's chain latency, not bytes
// or flops.  This first version keeps the scans linear and makes no
// attempt to hide that latency (incremental neighbour pointers, a warp
// per read and the records in shared memory are later work).
//
// Build (see kernels.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC.
// Under g++ -x c++ (no __CUDACC__) the same file compiles to the host
// test shim, which runs the rows in a loop.

#include "unrel_row.cuh"

#define UR_ARGS_DECL                                                      \
  const void *is_rel, const void *asgn0, const void *P13,                 \
      const void *packL, const void *packR, const void *idx_desc,         \
      const void *idx_asc, const void *live, const void *n, void *asgn,   \
      void *mm_out, int B, int N, const void *tab, const void *lf_small,  \
      int n1, const void *btg_flat, int n_cap, double read_len,           \
      double r_logp, double log_1m_pe_mean, double log_pe_mean,           \
      double dr_ratio, long long cov_r, long long cov_h, long long cov_d

static ur::Args ur_make_args(UR_ARGS_DECL) {
  ur::Args a;
  a.is_rel = (const unsigned char*)is_rel;
  a.asgn0 = (const int*)asgn0;
  a.P13 = (const double*)P13;
  a.packL = (const double*)packL;
  a.packR = (const double*)packR;
  a.idx_desc = (const int*)idx_desc;
  a.idx_asc = (const int*)idx_asc;
  a.live = (const unsigned char*)live;
  a.n = (const int*)n;
  a.asgn = (signed char*)asgn;
  a.mm_out = (double*)mm_out;
  a.B = B;
  a.N = N;
  a.P.tab = (const double*)tab;
  a.P.lf_small = (const double*)lf_small;
  a.P.n1 = n1;
  a.P.btg_flat = (const double*)btg_flat;
  a.P.n_cap = n_cap;
  a.P.read_len = read_len;
  a.P.r_logp = r_logp;
  a.P.log_1m_pe_mean = log_1m_pe_mean;
  a.P.log_pe_mean = log_pe_mean;
  a.P.dr_ratio = dr_ratio;
  a.P.cov_r = cov_r;
  a.P.cov_h = cov_h;
  a.P.cov_d = cov_d;
  return a;
}

#define UR_ARGS_PASS                                                      \
  is_rel, asgn0, P13, packL, packR, idx_desc, idx_asc, live, n, asgn,     \
      mm_out, B, N, tab, lf_small, n1, btg_flat, n_cap, read_len, r_logp, \
      log_1m_pe_mean, log_pe_mean, dr_ratio, cov_r, cov_h, cov_d

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void unrel_kernel(ur::Args a) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) ur::row(a, b);
}

// Launch on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int unrel_launch(UR_ARGS_DECL, void* stream) {
  ur::Args a = ur_make_args(UR_ARGS_PASS);
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0)
    unrel_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#else

// Host test shim: the same per-row body, rows in a loop.
extern "C" int unrel_host(UR_ARGS_DECL) {
  ur::Args a = ur_make_args(UR_ARGS_PASS);
  for (int b = 0; b < B; ++b) ur::row(a, b);
  return 0;
}

#endif
