// K2: cross-space sum + windowed winner-take-all.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_fused.py:_wta_kernel
// (launched by unskew_wta_planes, pallas_fused.py:354).  K1 already
// writes image layout, so the TPU kernel's unskew (a dynamic lane roll
// per row) has nothing left to do here.  For every pixel of every side:
// s = the sum of the nspaces planes, left to right in the space order
// A, B, V, PA, PB (the JAX assembly's association), cand = s inside the
// label window where -inf < s < inf (NaN excluded) and +inf elsewhere,
// cost = min(cand), idx = the lowest label with cand == cost, and
// disp = gmin + idx.  A batch of pairs shares one table of sides: side
// n takes entry n % nsides.  An all-invalid window gives idx 0 and cost +inf.
// With `taps`, also the four raw sums S[oc-1 .. oc+2] that the subpixel
// fits read, (N, R, 4, C), oc = clip(idx, 1, max(L - 3, 1)).
//
// Bound: one read of the (nspaces*N, R, C, L) float volume.  One warp
// per pixel: lanes stride the label axis (coalesced reads) and a
// shuffle reduction keeps the lowest label among equal minima; lanes
// 0-3 then gather the taps.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "mgm_kernels.h"

__global__ void wta_kernel(const WtaParams p) {
  const int lane = threadIdx.x & 31;
  const long long pix =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long npix = (long long)p.N * p.R * p.C;
  if (pix >= npix) return;  // the whole warp leaves together
  const int n = (int)(pix / ((long long)p.R * p.C));
  const long long rc = pix - (long long)n * p.R * p.C;
  const size_t plane = (size_t)p.R * p.C * p.L;
  const int sd = n % p.nsides;  // every pair of a batch: one side table
  const int lo = p.side_lo[sd], hi = p.side_hi[sd];
  float best = INFINITY;
  int bi = INT_MAX;
  for (int l = lane; l < p.L; l += 32) {
    const float* a = p.vol + (size_t)n * plane + (size_t)rc * p.L + l;
    float s = a[0];
    for (int si = 1; si < p.nspaces; ++si) s = s + a[(size_t)si * p.N * plane];
    const float cand =
        (l >= lo && l <= hi && s < INFINITY && s > -INFINITY) ? s : INFINITY;
    if (cand < best || (cand == best && l < bi)) {
      best = cand;
      bi = l;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ob < best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (lane == 0) {
    p.disp[pix] = (float)(p.side_gmin[sd] + bi);
    p.cost[pix] = best;
  }
  if (p.taps && lane < 4) {
    // every lane holds the winner: lane k writes tap k, the raw sum s
    // at clip(oc - 1 + k, 0, L - 1), oc = clip(idx, 1, max(L - 3, 1)),
    // summed as above so a NaN sum stays NaN (pallas_fused.py:228-240)
    const int top = p.L - 3 > 1 ? p.L - 3 : 1;
    const int oc = bi < 1 ? 1 : (bi > top ? top : bi);
    int pos = oc - 1 + lane;
    pos = pos < 0 ? 0 : (pos > p.L - 1 ? p.L - 1 : pos);
    const float* a = p.vol + (size_t)n * plane + (size_t)rc * p.L + pos;
    float s = a[0];
    for (int si = 1; si < p.nspaces; ++si) s = s + a[(size_t)si * p.N * plane];
    const long long r = rc / p.C;
    p.taps[(((size_t)n * p.R + r) * 4 + lane) * p.C + (rc - r * p.C)] = s;
  }
}

extern "C" int mgm_wta_params_size(void) { return (int)sizeof(WtaParams); }

extern "C" int mgm_wta(const WtaParams* params, void* stream) {
  const WtaParams p = *params;
  if (p.N < 1 || p.nsides < 1 || p.nsides > MGM_MAX_SIDES ||
      p.N % p.nsides != 0 || p.L < 1)
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)p.N * p.R * p.C;
  const int warps = 8;
  const long long blocks = (npix + warps - 1) / warps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  wta_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
