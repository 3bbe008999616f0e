// The two relaxation sweeps (K5) as one kernel for sm_90a, bound with
// ctypes.
//
// Replaces the JAX package's unrel_dev2.unrel_sweeps2 (unrel_dev2.py:67)
// and _unrel_lane's step_fn (:157-279), with the log-Skellam lookup of
// skellam_dev.logp_skellam_packed (:326) inlined as rd::skellam; the
// per-row body is unrel_row.cuh.
//
// Design: four lanes per read row (lane j runs slot j of the step: H-left,
// H-right, D-left, D-right), eight rows per one-warp block, so a 256-row
// chunk is 32 blocks.  Each row first copies its packL / packR records
// into shared memory, compacts its active steps (both sweeps, in step
// order) with a group ballot, and builds two bitmasks over its columns,
// the reliable intervals assigned H and those assigned D, with a summary
// word per 1024 columns.  A step then finds each slot's nearest neighbour
// by a bit scan of the mask words (unrel_row.cuh) and reads its record;
// the four slots issue their Skellam table gathers, then run their
// interpolation, tail gather and lookup side by side; four shuffle rounds
// carry the cross-slot terms, lane 0 decides and updates w and the masks.
// The records, step list, w and masks live in shared memory while the
// block's rows fit its 227 KB (max_n <= 507: 88 KB at max_n 192), beyond
// that in a global scratch, the records then read from the inputs; the
// step's 13-plane record is loaded one active step ahead; the row is
// written out once, at the end.
//
// This replaces the first version's one thread per row, which scanned
// outward from idx over the row in global memory for the four neighbours
// (O(n) dependent byte loads a step) and ran the four slots' divisions and
// lookups one after another on one lane.
//
// What bounds it on the card: a row is still a dependent chain of its
// active steps, each step depending on the assignments the earlier ones
// wrote.  A step's chain is the bit scan and the neighbour's record in
// shared memory, one Skellam lookup (divisions, sqrt, floor, a 40-byte
// table gather from device memory, log) with the interpolation division
// and the tail gather under it, four shuffles and lane 0's compare-select
// chain; the time is the longest row's chain, not bytes or flops
// (PERF.md: cycles per step by phase, chip_smoke.py --phases k5profile).
//
// unrel_gate_kernel is the same body with the gate tail (unrel_row.cuh):
// the all-device chunk's launch, which writes each row with the read's
// guard flag as its last byte, the packed result the host copies back
// (it replaces classify_batch_dev's flag, device_pipeline.py:698-705).

// Build (see kernels.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -Xptxas -v -shared -Xcompiler -fPIC.
// Under g++ -x c++ (no __CUDACC__) the same file compiles to the host
// test shim, which runs each warp's 32 lanes phase by phase.

#include "unrel_row.cuh"

#define UR_ARGS_DECL                                                      \
  const void *is_rel, const void *asgn0, const void *P13,                 \
      const void *packL, const void *packR, const void *idx_desc,         \
      const void *idx_asc, const void *live, const void *n,               \
      const void *gate, void *asgn, void *mm_out, void *scratch, int B,    \
      int N, const void *tab, const void *lf_small,                        \
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
  a.gate = (const double*)gate;
  a.asgn = (signed char*)asgn;
  a.mm_out = (double*)mm_out;
  a.scratch = (unsigned char*)scratch;
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
  is_rel, asgn0, P13, packL, packR, idx_desc, idx_asc, live, n, gate,    \
      asgn, mm_out, scratch, B, N, tab, lf_small, n1, btg_flat, n_cap,    \
      read_len, r_logp, log_1m_pe_mean, log_pe_mean, dr_ratio, cov_r, cov_h, cov_d

// Launch geometry: one warp per block, ROWS_PER_WARP rows per block.
constexpr int UR_THREADS = rd::WARP;
constexpr int UR_ROWS_PER_BLOCK = UR_THREADS / ur::G;
constexpr long long UR_SMEM_MAX = 227 * 1024;   // a block's dynamic maximum

static int ur_blocks(int B) {
  return (B + UR_ROWS_PER_BLOCK - 1) / UR_ROWS_PER_BLOCK;
}
// a block's rows, with their records, fit its shared memory
static bool ur_in_smem(int N) {
  return UR_ROWS_PER_BLOCK * ur::layout(N, true).row_bytes <= UR_SMEM_MAX;
}

// out[0..5] = lanes per row, rows per warp, threads per block, blocks,
// shared bytes per block (0: the rows live in the global scratch), and the
// bytes of one row's state (the scratch holds B of them) for (B, N).
extern "C" int unrel_geometry(int B, int N, long long* out) {
  const bool sm = ur_in_smem(N);
  const long long row = ur::layout(N, sm).row_bytes;
  out[0] = ur::G;
  out[1] = ur::ROWS_PER_WARP;
  out[2] = UR_THREADS;
  out[3] = ur_blocks(B);
  out[4] = sm ? UR_ROWS_PER_BLOCK * row : 0;
  out[5] = row;
  return 0;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char ur_smem[];

template <bool TAIL>
__device__ __forceinline__ void unrel_block(const ur::Args& a,
                                            int use_smem) {
  ur::Scratch scr{a.scratch, 0, false};
  if (use_smem) {
    scr.base = ur_smem;
    scr.row0 = blockIdx.x * UR_ROWS_PER_BLOCK;
    scr.packs = true;
  }
  ur::warp_rows<1, TAIL>(a, blockIdx.x * blockDim.x + threadIdx.x, scr);
}

__global__ void __launch_bounds__(UR_THREADS)
unrel_kernel(ur::Args a, int use_smem) {
  unrel_block<false>(a, use_smem);
}

// with the gate tail: the rows and their guard flags, packed
__global__ void __launch_bounds__(UR_THREADS)
unrel_gate_kernel(ur::Args a, int use_smem) {
  unrel_block<true>(a, use_smem);
}

// The dynamic shared bytes each kernel may take on each device, raised
// (a call outside the stream) only when a launch needs more: the first
// launch of a bucket, which a CUDA graph's capture follows, so that no
// such call falls inside a capture.
constexpr int UR_MAX_DEVICES = 64;
static int ur_smem_set[2][UR_MAX_DEVICES];

static int ur_allow_smem(const void* kernel, int tail, int bytes) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= UR_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= ur_smem_set[tail][dev]) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) ur_smem_set[tail][dev] = bytes;
  return err;
}

// Launch on ``stream`` (unrel_gate_kernel where ``gate`` is given);
// returns the CUDA error (0 = launched).
extern "C" int unrel_launch(UR_ARGS_DECL, void* stream) {
  ur::Args a = ur_make_args(UR_ARGS_PASS);
  long long geo[6];
  unrel_geometry(B, N, geo);
  const int tail = gate != nullptr;
  const void* kernel = tail ? (const void*)unrel_gate_kernel
                            : (const void*)unrel_kernel;
  const int err = ur_allow_smem(kernel, tail, (int)geo[4]);
  if (err != 0) return err;
  if (geo[3] > 0) {
    if (tail)
      unrel_gate_kernel<<<(int)geo[3], UR_THREADS, (size_t)geo[4],
                          (cudaStream_t)stream>>>(a, geo[4] > 0);
    else
      unrel_kernel<<<(int)geo[3], UR_THREADS, (size_t)geo[4],
                     (cudaStream_t)stream>>>(a, geo[4] > 0);
  }
  return (int)cudaGetLastError();
}

#ifdef RD_PHASE_CLOCKS
// The phase clocks' sums (unrel_row.cuh), and their reset.
extern "C" int unrel_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[rd::NPART + 1] = {0};
    return (int)cudaMemcpyToSymbol(rd::rd_phase_clocks, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, rd::rd_phase_clocks,
                                   (rd::NPART + 1) * sizeof(unsigned long long));
}
#endif

#else

// Host test shim: the same warp body (with the gate tail where ``gate``
// is given), one warp's 32 lanes per call, over the warps of the launch;
// the rows' state lives in the global scratch, in the card's layout (with
// the records where the card keeps them in shared memory).
extern "C" int unrel_host(UR_ARGS_DECL) {
  ur::Args a = ur_make_args(UR_ARGS_PASS);
  const ur::Scratch scr{a.scratch, 0, ur_in_smem(N)};
  const int lanes = ur_blocks(B) * UR_THREADS;
  for (int g0 = 0; g0 < lanes; g0 += rd::WARP) {
    if (gate)
      ur::warp_rows<rd::WARP, true>(a, g0, scr);
    else
      ur::warp_rows<rd::WARP, false>(a, g0, scr);
  }
  return 0;
}

#endif
