// K5: the dense MGM recursion over a skewed canonical pass group.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_wavefront.py:_kernel (its
// front update _front_update, :177; launched by wavefront_scan, :328).
// It computes the same thing: for every front t of the skewed volume
// (row r holds canonical pixel (r, t - slope*r)), each pixel's 1-4
// coupled messages from the causal offsets W / N / NW / NE / WWN, SGM
// or truncated-linear (FH, by log2(L) min-plus doubling steps), with
// optional per-offset weights and the FH label-window restriction, the
// update_cost2 halving quirk, the 1-pixel border rule (two columns on
// the left for knight passes), and the per-pixel minimum of the new
// front that later fronts read.
//
// What is not carried over is the TPU's blocking: the G-front VMEM
// blocks and the D-deep history scratch.  The volume is updated in
// place, so the history is the volume itself (plus the (M, R, T)
// minima): front t reads fronts t - lag, which earlier launches wrote.
// Fronts synchronise by kernel boundaries, one launch per front on the
// caller's stream, T = C + slope*(R-1) launches.  Inside a front, one
// block per (active row, pass plane) and one thread per label; label
// shifts go through shared memory, the minimum through warp shuffles.
//
// Bound: the chain of T dependent launches and their short per-front
// work, then one read and one write of the volume's real cells
// (0 <= t - slope*r < C) and their minima; the skew's fill is never
// read or written.
//
// Numerics follow the plain PyTorch version in ops/wavefront.py
// operation for operation (built with --fmad=false, no fast math).
// Minima keep NaN as torch.minimum does: border messages may be
// inf - inf, and the interior select never reads them.
#include <cuda_runtime.h>
#include <math.h>

#include "mgm_kernels.h"

// torch.minimum on CUDA: a NaN operand wins, else the smaller value
__device__ __forceinline__ float nmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__global__ void scan_front(const ScanParams p, int t, int r0) {
  __shared__ float buf[MGM_MAX_LABELS];
  __shared__ float red[32];
  const int r = r0 + blockIdx.x;
  const int m = blockIdx.y;
  const int l = threadIdx.x;
  const int ii = t - p.slope * r;  // a column of the image: 0 <= ii < C
  const bool act = l < p.L;
  const size_t cell = ((size_t)m * p.R + r) * p.T + t;
  const float cc = act ? p.vol[cell * p.L + l] : INFINITY;
  // the same for every thread of the block, so the barriers below are
  // reached by all of them
  const bool interior =
      r >= 1 && (p.knight ? (ii >= 2 && ii <= p.C - 1)
                          : (ii >= 1 && ii <= p.C - 2));
  float nv = cc;
  if (interior) {
    float msg[MGM_MAX_OFFS];
    bool win = true;
    if (p.fh_restrict) win = l >= p.lo[cell] && l <= p.hi[cell];
    for (int k = 0; k < p.noffs; ++k) {
      const size_t ncell =
          ((size_t)m * p.R + r - p.off_shift[k]) * p.T + t - p.off_lag[k];
      const float* h = p.vol + ncell * p.L;
      const float mk = p.mins[ncell];
      float p1w = p.p1, p2w = p.p2;
      if (p.use_weights) {
        const float d = p.w[(((size_t)k * p.M + m) * p.R + r) * p.T + t];
        p1w = d * p.p1;
        p2w = d * p.p2;
      }
      if (!p.use_fh) {
        // min(Lk, min(Lk[l-1], Lk[l+1]) + P1, mk + P2) - mk
        const float lk = act ? h[l] : INFINITY;
        const float lm = act && l > 0 ? h[l - 1] : INFINITY;
        const float lp = act && l < p.L - 1 ? h[l + 1] : INFINITY;
        msg[k] = nmin(nmin(lk, nmin(lm, lp) + p1w), mk + p2w) - mk;
      } else {
        // min over labels j of Lk[j] + P1*|l - j|, capped at mk + P2:
        // doubling shifts up, then down (pallas_wavefront._fh_msg)
        float v = act && win ? h[l] : INFINITY;
        for (int s = 1; s < p.L; s *= 2) {
          buf[l] = v;
          __syncthreads();
          const float sh = act && l >= s ? buf[l - s] : INFINITY;
          v = nmin(v, sh + p1w * (float)s);
          __syncthreads();
        }
        for (int s = 1; s < p.L; s *= 2) {
          buf[l] = v;
          __syncthreads();
          const float sh = act && l + s < p.L ? buf[l + s] : INFINITY;
          v = nmin(v, sh + p1w * (float)s);
          __syncthreads();
        }
        v = nmin(v, mk + p2w);
        msg[k] = v - mk;
      }
    }
    float e;
    if (p.mgm == 2 && !p.use_weights && !p.use_fh) {
      // update_cost2 halves each term before summing (mgm_core.cc:83-84)
      e = msg[p.dir_rank[0]] * 0.5f + msg[p.dir_rank[1]] * 0.5f;
    } else {
      e = msg[p.dir_rank[0]];
      for (int j = 1; j < p.mgm; ++j) e = e + msg[p.dir_rank[j]];
      if (p.mgm > 1) e = e / (float)p.mgm;
    }
    nv = cc + e;
  }
  if (act) p.vol[cell * p.L + l] = nv;
  float mv = nv;
  for (int off = 16; off > 0; off >>= 1)
    mv = nmin(mv, __shfl_xor_sync(0xffffffffu, mv, off));
  if ((l & 31) == 0) red[l >> 5] = mv;
  __syncthreads();
  if (l == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mv = nmin(mv, red[w]);
    p.mins[cell] = mv;
  }
}

extern "C" int mgm_scan_params_size(void) { return (int)sizeof(ScanParams); }

// Runs every front of one pass group on `stream`; returns the first
// CUDA error (0 when all launches were accepted).
extern "C" int mgm_wavefront_scan(const ScanParams* params, void* stream) {
  const ScanParams p = *params;
  if (p.L < 1 || p.L > MGM_MAX_LABELS || p.mgm < 1 ||
      p.mgm > MGM_MAX_RANKS || p.noffs < 1 || p.noffs > MGM_MAX_OFFS ||
      p.slope < 1 || p.M < 1 || p.R < 1 || p.C < 1 ||
      p.T != p.C + p.slope * (p.R - 1))
    return (int)cudaErrorInvalidValue;
  const int threads = (p.L + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
  for (int t = 0; t < p.T; ++t) {
    // rows whose pixel on front t lies in the image: 0 <= t - slope*r < C
    const int lo = t - (p.C - 1);
    const int r0 = lo > 0 ? (lo + p.slope - 1) / p.slope : 0;
    const int r1 = t / p.slope < p.R - 1 ? t / p.slope : p.R - 1;
    if (r0 > r1) continue;
    scan_front<<<dim3(r1 - r0 + 1, p.M), threads, 0, s>>>(p, t, r0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
