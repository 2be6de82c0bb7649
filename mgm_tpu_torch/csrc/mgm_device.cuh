// Device functions shared by the port's kernels: the pointwise matching
// costs (K1 computes them in flight, K8 into a volume) and the MGM
// messages (K1, K4 and K5).  One definition each, so the kernels agree with
// each other and with the plain PyTorch versions they are held against
// (ops/cuda_cost.pointwise_cost, ops/wavefront._sgm_msg / _fh_msg);
// K1 runs fh_msg's doubling in registers across a warp's lanes
// (csrc/fused_wavefront.cu), step for step.
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

// The NaN-keeping minimum of v over the warp (every lane gets it).
__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

// Raw cost of one (pixel, label) pair (mgm_costvolume.h:19-133): the
// left image's pixel at element offset `up`, the right image's at `vp`,
// nch channels each.  ad/sd: the channels' terms summed left to right;
// census (int32 words): popcount of the XOR'd words times inv_nw =
// 1/nwords; btad/btsd: the terms of the [I, Imin, Imax] channel blocks
// (nch = 3 * channels) summed left to right.  K1 sums the same terms in
// the same order for a warp's labels at once (csrc/fused_wavefront.cu
// slot_costs).
__device__ __forceinline__ float pointwise_cost(int mode, const void* left,
                                                const void* right, size_t up,
                                                size_t vp, int nch,
                                                float inv_nw) {
  float acc = 0.f;
  if (mode == MGM_COST_CENSUS) {
    const unsigned* u = (const unsigned*)left + up;
    const unsigned* v = (const unsigned*)right + vp;
    int bits = 0;
    for (int c = 0; c < nch; ++c) bits += __popc(u[c] ^ v[c]);
    return (float)bits * inv_nw;
  }
  const float* u = (const float*)left + up;
  const float* v = (const float*)right + vp;
  if (mode == MGM_COST_AD || mode == MGM_COST_SD) {
    for (int c = 0; c < nch; ++c) {
      const float d = ad_term(mode, u[c], v[c]);
      acc = c ? acc + d : d;
    }
    return acc;
  }
  const int C = nch / 3;
  for (int c = 0; c < C; ++c) {
    const float bt = bt_term(mode, u[c], u[C + c], u[2 * C + c], v[c],
                             v[C + c], v[2 * C + c]);
    acc = c ? acc + bt : bt;
  }
  return acc;
}

// SGM message of one label (mgm_core.cc:74-76,113-116): lk = Lk[l],
// lm/lp = Lk[l -+ 1] (+inf beyond the labels), mk = min Lk:
// min(lk, min(lm, lp) + P1w, mk + P2w) - mk
__device__ __forceinline__ float sgm_msg(float lk, float lm, float lp,
                                         float mk, float p1w, float p2w) {
  return nmin(nmin(lk, nmin(lm, lp) + p1w), mk + p2w) - mk;
}

// Truncated-linear (FH) message of label l = threadIdx.x: the min over
// labels j of Lk[j] + P1w*|l - j|, capped at mk + P2w, minus mk, by
// min-plus doubling up then down (mgm_core.cc:152-163 in 2*ceil(log2 L)
// steps; pallas_wavefront._fh_msg).  v is Lk[l], +inf for the lanes
// l >= L, which read +inf beyond the labels.  `buf` holds blockDim.x
// floats of shared memory.  Each step writes buf, waits, reads its
// neighbour and waits again before the next write, so EVERY thread of
// the block must call this: mask lanes through v, never by skipping it.
__device__ __forceinline__ float fh_msg(float* buf, float v, int L,
                                        float mk, float p1w, float p2w) {
  const int l = threadIdx.x;
  for (int s = 1; s < L; s *= 2) {
    buf[l] = v;
    __syncthreads();
    const float sh = l < L && l >= s ? buf[l - s] : INFINITY;
    v = nmin(v, sh + p1w * (float)s);
    __syncthreads();
  }
  for (int s = 1; s < L; s *= 2) {
    buf[l] = v;
    __syncthreads();
    const float sh = l + s < L ? buf[l + s] : INFINITY;
    v = nmin(v, sh + p1w * (float)s);
    __syncthreads();
  }
  return nmin(v, mk + p2w) - mk;
}
