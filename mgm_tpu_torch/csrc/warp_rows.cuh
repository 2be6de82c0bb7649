// Warp-level pieces of the wavefront kernels that hold a row (or two)
// in a warp, labels across the lanes: K1 (csrc/fused_wavefront.cuh) and
// K5 (csrc/wavefront.cu).  The row counts rows synchronise by, the
// NaN-keeping minimum over a lane segment, FH's min-plus doubling in
// registers and the SGM / FH message folded into a sum.
#pragma once

#include "mgm_device.cuh"

#define FULL_MASK 0xffffffffu

// The lanes of a row (a warp holds 32 / NL rows, one a lane segment) and
// the labels a lane (K) for L labels: (16, 3) up to L = 48, (32, 2) to
// 64, (32, 5) to 160, (32, 6) to 192, (32, 32) to 1024 (MGM_MAX_LABELS).
__host__ __device__ constexpr int labels_a_lane(int L) {
  return L <= 48 ? 3 : L <= 64 ? 2 : L <= 160 ? 5 : L <= 192 ? 6 : 32;
}

// A row's count of finished fronts: the first lane of its segment
// stores it with release semantics after the row's writes (K1: its ring
// rows; K5: its volume cells and minima) at CTA scope; at cluster scope
// for a row with a neighbour in another CTA of K1's cluster, which reads
// the count through distributed shared memory; a reader spins on it with
// acquire semantics at the same scope, then reads that row through L1
// within the CTA, from L2 (ld.global.cg) otherwise.
__device__ __forceinline__ void publish_cta(int* done, int u) {
  asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(done), "r"(u)
               : "memory");
}

__device__ __forceinline__ void publish_cluster(int* done, int u) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(done), "r"(u)
               : "memory");
}

__device__ __forceinline__ void wait_cta(const int* done, int u) {
  for (;;) {
    int d;
    asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(d) : "l"(done)
                 : "memory");
    if (d >= u) return;
    __nanosleep(32);
  }
}

__device__ __forceinline__ void wait_cluster(const int* done, int u) {
  for (;;) {
    int d;
    asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(d) : "l"(done)
                 : "memory");
    if (d >= u) return;
    __nanosleep(32);
  }
}

// A count in the global array, for a neighbour row in another cluster
// (L2; release/acquire at GPU scope).
__device__ __forceinline__ void publish_gpu(unsigned long long* done,
                                            unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(done), "l"(v)
               : "memory");
}

__device__ __forceinline__ void wait_gpu(const unsigned long long* done,
                                         unsigned long long v) {
  for (;;) {
    unsigned long long d;
    asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(d) : "l"(done)
                 : "memory");
    if (d >= v) return;
    __nanosleep(32);
  }
}

// One read of a global count with acquire semantics (K5 polls with it
// and keeps the value it last read).
__device__ __forceinline__ unsigned long long acquire_gpu(
    const unsigned long long* done) {
  unsigned long long d;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(d) : "l"(done)
               : "memory");
  return d;
}

// The NaN-keeping minimum of v over each NL-lane segment of the warp
// (every lane gets its segment's).
template <int NL>
__device__ __forceinline__ float seg_min(float v) {
#pragma unroll
  for (int off = NL / 2; off > 0; off >>= 1)
    v = nmin(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// Slot `idx` of v (after unrolling a constant) read from lane `src` of
// this lane's NL-lane segment (B != 0) or from this lane; +inf outside
// the slots.
template <int K, int NL, int B>
__device__ __forceinline__ float slot_from(const float (&v)[K], int idx,
                                           int src) {
  if (idx < 0 || idx >= K) return INFINITY;
  return B ? __shfl_sync(FULL_MASK, v[idx], src, NL) : v[idx];
}

// One upward FH step of shift S: v[l] = nmin(v[l], v_old[l - S] + c),
// +inf below label 0.  Label l = i*NL + sl (sl: the lane within its
// segment); l - S lies in slot i - A at sub-lane sl - B, or for sub-lanes
// < B in slot i - A - 1; slots descend, so every read sees an old
// value, and each slot is shuffled once.
template <int K, int NL, int S>
__device__ __forceinline__ void fh_up_step(float (&v)[K], float c, int sl) {
  constexpr int A = S / NL, B = S % NL;
  const int src = (sl - B) & (NL - 1);
  const bool same = sl >= B;
  float carry = slot_from<K, NL, B>(v, K - 1 - A, src);
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    const float x1 = slot_from<K, NL, B>(v, i - A - 1, src);
    v[i] = nmin(v[i], (same ? carry : x1) + c);
    carry = x1;
  }
}

// One downward step: v[l] = nmin(v[l], v_old[l + S] + c); labels >= L
// must hold +inf (they read as _fh_msg's shift fill beyond L).
template <int K, int NL, int S>
__device__ __forceinline__ void fh_down_step(float (&v)[K], float c,
                                             int sl) {
  constexpr int A = S / NL, B = S % NL;
  const int src = (sl + B) & (NL - 1);
  const bool same = sl + B < NL;
  float carry = slot_from<K, NL, B>(v, A, src);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float x1 = slot_from<K, NL, B>(v, i + A + 1, src);
    v[i] = nmin(v[i], (same ? carry : x1) + c);
    carry = x1;
  }
}

// The min-plus doubling of ops/wavefront._fh_msg on the first mgm deps'
// rows v[j] at once (their steps interleave), s = 2^E while s < L,
// p1w[j] * (float)s as there.
template <int K, int NL, int E = 0>
__device__ __forceinline__ void fh_up(float (&v)[MGM_MAX_RANKS][K],
                                      const float (&p1w)[MGM_MAX_RANKS],
                                      int mgm, int L, int sl) {
  constexpr int S = 1 << E;
  if constexpr (S < NL * K) {
    if (S >= L) return;
#pragma unroll
    for (int j = 0; j < MGM_MAX_RANKS; ++j)
      if (j < mgm) fh_up_step<K, NL, S>(v[j], p1w[j] * (float)S, sl);
    fh_up<K, NL, E + 1>(v, p1w, mgm, L, sl);
  }
}

template <int K, int NL, int E = 0>
__device__ __forceinline__ void fh_down(float (&v)[MGM_MAX_RANKS][K],
                                        const float (&p1w)[MGM_MAX_RANKS],
                                        int mgm, int L, int sl) {
  constexpr int S = 1 << E;
  if constexpr (S < NL * K) {
    if (S >= L) return;
#pragma unroll
    for (int j = 0; j < MGM_MAX_RANKS; ++j)
      if (j < mgm) fh_down_step<K, NL, S>(v[j], p1w[j] * (float)S, sl);
    fh_down<K, NL, E + 1>(v, p1w, mgm, L, sl);
  }
}

// Message j folded into acc (the first message, a sum, or
// update_cost2's halves): FH from dep j's doubled row v, SGM from its
// loaded row.
template <bool FH, int K, int NL>
__device__ __forceinline__ void fold_message(const float (&v)[K], float mk,
                                             float p1w, float p2w, int j,
                                             bool halve, int nk, int sl,
                                             float (&acc)[K]) {
  // SGM: the l - 1 neighbour is the previous sub-lane's (sub-lane 0: the
  // slot below's last), the l + 1 one the next sub-lane's (the last: the
  // slot above's sub-lane 0)
  float below = INFINITY, above = INFINITY;
  if constexpr (!FH)
    above = __shfl_sync(FULL_MASK, v[0], (sl + 1) & (NL - 1), NL);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (K > 6 && s >= nk) break;  // the 32-label instance's idle slots
    float msg;
    if constexpr (FH) {
      msg = nmin(v[s], mk + p2w) - mk;
    } else {
      const float dn =
          __shfl_sync(FULL_MASK, v[s], (sl + NL - 1) & (NL - 1), NL);
      const float up = s + 1 < K
          ? __shfl_sync(FULL_MASK, v[s + 1 < K ? s + 1 : 0],
                        (sl + 1) & (NL - 1), NL)
          : INFINITY;
      msg = sgm_msg(v[s], sl >= 1 ? dn : below, sl <= NL - 2 ? above : up,
                    mk, p1w, p2w);
      below = dn;
      above = up;
    }
    if (j == 0)
      acc[s] = msg;
    else if (halve)  // update_cost2 (mgm_core.cc:83-84)
      acc[s] = acc[s] * 0.5f + msg * 0.5f;
    else
      acc[s] = acc[s] + msg;
  }
}
