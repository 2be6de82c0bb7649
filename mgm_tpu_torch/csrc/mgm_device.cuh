// Device functions shared by the port's kernels: the pointwise matching
// costs (K1 and K4 compute them in flight, K8 into a volume) and the SGM
// message (K1, K4 and K5).  One definition each, so the kernels agree with
// each other and with the plain PyTorch versions they are held against
// (ops/cuda_cost.pointwise_cost, ops/wavefront._sgm_msg); the FH message's
// min-plus doubling runs in registers across a warp's lanes
// (csrc/warp_rows.cuh), step for step as ops/wavefront._fh_msg.
// Built with --fmad=false and no fast math: every sum and product
// rounds on its own, and inf/NaN behave as IEEE says.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mgm_kernels.h"

// torch.minimum's semantics: a NaN operand gives NaN, else the smaller
// value.  One instruction (sm_80+ `min.NaN`), where fminf would drop the
// NaN and a compare-and-select chain costs several on every reduction
// step of the recursion.
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One channel's term of the ad / sd cost: |u - v|, squared for sd.
__device__ __forceinline__ float ad_term(int mode, float u, float v) {
  const float d = fabsf(u - v);
  return mode == MGM_COST_SD ? d * d : d;
}

// One channel's Birchfield-Tomasi term (btad; squared for btsd) from
// the left pixel's I, Imin, Imax and the right pixel's, with a
// NaN-keeping minimum (torch.minimum's semantics; the zero signs it may
// differ in vanish in the abs).
__device__ __forceinline__ float bt_term(int mode, float il, float umin,
                                         float umax, float ir, float vmin,
                                         float vmax) {
  const float dlr = -nmin(nmin(0.f, -(il - vmax)), -(vmin - il));
  const float drl = -nmin(nmin(0.f, -(ir - umax)), -(umin - ir));
  const float bt = fabsf(nmin(dlr, drl));
  return mode == MGM_COST_BTSD ? bt * bt : bt;
}

// Raw cost of one (pixel, label) pair (mgm_costvolume.h:19-133), the
// family MODE and channel count NCH fixed at compile time (NCH 0: `nch`
// at run time): the left pixel's channels at u[0 .. nch), the right
// pixel's at v[c * vstride].  ad/sd: the channels' terms summed left to
// right; census (T unsigned words): popcount of the XOR'd words times
// inv_nw = 1/nwords; btad/btsd: the terms of the [I, Imin, Imax]
// channel blocks (nch = 3 * channels) summed left to right.  K8 reads it
// from shared memory; K1 sums the same terms in the same order for a
// warp's labels at once (csrc/fused_wavefront.cuh slot_costs).
template <int MODE, int NCH, typename T>
__device__ __forceinline__ float pair_cost(const T* u, const T* v,
                                           int vstride, int nch,
                                           float inv_nw) {
  const int n = NCH ? NCH : nch;
  if constexpr (MODE == MGM_COST_CENSUS) {
    int bits = 0;
#pragma unroll
    for (int c = 0; c < n; ++c) bits += __popc(u[c] ^ v[c * vstride]);
    return (float)bits * inv_nw;
  } else if constexpr (MODE == MGM_COST_AD || MODE == MGM_COST_SD) {
    float acc = ad_term(MODE, u[0], v[0]);
#pragma unroll
    for (int c = 1; c < n; ++c) acc = acc + ad_term(MODE, u[c], v[c * vstride]);
    return acc;
  } else {
    const int C = n / 3;
    float acc = bt_term(MODE, u[0], u[C], u[2 * C], v[0], v[C * vstride],
                        v[2 * C * vstride]);
#pragma unroll
    for (int c = 1; c < C; ++c)
      acc = acc + bt_term(MODE, u[c], u[C + c], u[2 * C + c], v[c * vstride],
                          v[(C + c) * vstride], v[(2 * C + c) * vstride]);
    return acc;
  }
}

// SGM message of one label (mgm_core.cc:74-76,113-116): lk = Lk[l],
// lm/lp = Lk[l -+ 1] (+inf beyond the labels), mk = min Lk:
// min(lk, min(lm, lp) + P1w, mk + P2w) - mk
__device__ __forceinline__ float sgm_msg(float lk, float lm, float lp,
                                         float mk, float p1w, float p2w) {
  return nmin(nmin(lk, nmin(lm, lp) + p1w), mk + p2w) - mk;
}
