// Lane primitives shared by the DP kernel (rel_dp_row.cuh) and the sweep
// kernel (unrel_row.cuh).  Both run a row on a group of G lanes of a warp
// and keep every lane in the loop until the warp's longest row ends, so
// every exchange has all 32 lanes.
//
// Each primitive takes NL lanes at once.  On the card a thread is one lane
// (NL == 1) and the primitive is a shuffle, a ballot or a warp reduction;
// in the host test shim (the same headers under g++ -x c++) one thread
// holds a whole warp's 32 lanes, phase by phase, and the primitive reads
// the arrays.  Lane l of a call is lane wl[l] of its warp; its group is
// the G lanes from wl[l] & ~(G - 1).

#pragma once

#include "rd_math.cuh"

namespace rd {

constexpr int WARP = 32;

// out[l] = v[src[l]] over the warp's lanes
template <int NL, class T>
RD_FN void xchg(const T (&v)[NL], const int (&src)[NL], T (&out)[NL]) {
#ifdef __CUDA_ARCH__
  out[0] = __shfl_sync(0xffffffffu, v[0], src[0]);
#else
  for (int l = 0; l < NL; ++l) out[l] = v[src[l]];
#endif
}

// the warp's maximum of non-negative v
template <int NL>
RD_FN int warp_max(const int (&v)[NL]) {
#ifdef __CUDA_ARCH__
  return (int)__reduce_max_sync(0xffffffffu, (unsigned)v[0]);
#else
  int mx = 0;
  for (int l = 0; l < NL; ++l) mx = v[l] > mx ? v[l] : mx;
  return mx;
#endif
}

// orders the warp's shared-memory writes before its later reads
RD_FN void warp_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// bit k = v of lane k of this lane's group of G
template <int G, int NL>
RD_FN void row_bits(const bool (&v)[NL], const int (&wl)[NL],
                    unsigned (&out)[NL]) {
  constexpr unsigned ALL = G == 32 ? 0xffffffffu : (1u << G) - 1u;
#ifdef __CUDA_ARCH__
  out[0] = (__ballot_sync(0xffffffffu, v[0]) >> (wl[0] & ~(G - 1))) & ALL;
#else
  for (int l = 0; l < NL; ++l) {
    const int b0 = wl[l] & ~(G - 1);
    out[l] = 0;
    for (int k = 0; k < G; ++k) out[l] |= (v[b0 + k] ? 1u : 0u) << k;
  }
#endif
}

// out[l][k] = v of lane k of lane l's group of G (G >= 4)
template <int G, int NL, class T>
RD_FN void gather4(const T (&v)[NL], const int (&wl)[NL], T (&out)[NL][4]) {
  RD_UNROLL
  for (int k = 0; k < 4; ++k) {
    int src[NL];
    T o[NL];
    for (int l = 0; l < NL; ++l) src[l] = (wl[l] & ~(G - 1)) + k;
    xchg<NL>(v, src, o);
    for (int l = 0; l < NL; ++l) out[l][k] = o[l];
  }
}

// out[l] = v of lane k of lane l's group of G
template <int G, int NL, class T>
RD_FN void from_lane(const T (&v)[NL], const int (&wl)[NL], int k,
                     T (&out)[NL]) {
  int src[NL];
  for (int l = 0; l < NL; ++l) src[l] = (wl[l] & ~(G - 1)) + k;
  xchg<NL>(v, src, out);
}

// out[l] = v of lane (its index in the group) ^ m of lane l's group
template <int NL, class T>
RD_FN void from_xor(const T (&v)[NL], const int (&wl)[NL], int m,
                    T (&out)[NL]) {
  int src[NL];
  for (int l = 0; l < NL; ++l) src[l] = wl[l] ^ m;
  xchg<NL>(v, src, out);
}

// bit scans of a 32-bit word: the highest set bit (x != 0), the word
// bit-reversed, the number of set bits
RD_FN int top_bit(unsigned x) {
#ifdef __CUDA_ARCH__
  return 31 - __clz((int)x);
#else
  return 31 - __builtin_clz(x);
#endif
}
RD_FN unsigned brev32(unsigned x) {
#ifdef __CUDA_ARCH__
  return __brev(x);
#else
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0f0f0f0fu) | ((x & 0x0f0f0f0fu) << 4);
  x = ((x >> 8) & 0x00ff00ffu) | ((x & 0x00ff00ffu) << 8);
  return (x >> 16) | (x << 16);
#endif
}
RD_FN int popc32(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Phase clocks, only in a build with -DRD_PHASE_CLOCKS (chip_smoke.py
// --phases k1profile, k5profile): lane 0 of every row adds the cycles of
// each of the seven parts of its warp's steps (each kernel names its
// parts) into rd_phase_clocks[0..6] and the steps into [7].
constexpr int NPART = 7;
#if defined(RD_PHASE_CLOCKS) && defined(__CUDACC__)
__device__ unsigned long long rd_phase_clocks[NPART + 1];
#endif
#if defined(RD_PHASE_CLOCKS) && defined(__CUDA_ARCH__)
#define RD_CLOCKS long long rd_acc[::rd::NPART] = {0}, rd_t[::rd::NPART + 1]
#define RD_MARK(k) rd_t[k] = clock64()
#define RD_ADD_STEP                                                      \
  for (int k = 0; k < ::rd::NPART; ++k) rd_acc[k] += rd_t[k + 1] - rd_t[k]
#define RD_FLUSH(lane0, steps)                                           \
  if (lane0) {                                                           \
    for (int k = 0; k < ::rd::NPART; ++k)                                \
      atomicAdd(&::rd::rd_phase_clocks[k], (unsigned long long)rd_acc[k]); \
    atomicAdd(&::rd::rd_phase_clocks[::rd::NPART],                       \
              (unsigned long long)(steps));                              \
  }
#else
#define RD_CLOCKS
#define RD_MARK(k)
#define RD_ADD_STEP
#define RD_FLUSH(lane0, steps)
#endif

}  // namespace rd
