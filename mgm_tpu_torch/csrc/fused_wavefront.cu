// K1: fused cost + MGM recursion, one scan direction.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_fused.py:_kernel (launched
// by fused_wavefront, pallas_fused.py:1057).  It computes the same
// thing: for every front t of a skewed schedule (pixel (r, col) of a
// plane lies on front t = fstep*col + a0 - ssgn*slope*r), the cost of
// each label in flight from the two images (ad, sd, census on int32
// words, btad/btsd on [I, Imin, Imax] blocks: mgm_device.cuh's
// pointwise_cost, which K8 shares), the 1-4 coupled SGM or FH messages
// from the fronts t -+ lag, optionally with per-pixel edge weights, the
// update_cost2 quirk, the 1-pixel border rule, the optional kappa*CC
// overcount fold and the backward launch's accumulation onto the
// forward launch's output.  The label window is each plane's constant
// one, or each pixel's (-m/-M: (N, R, C) lo/hi planes, read once a
// block), and with the truncated-linear potential under per-pixel
// windows (`fh_restrict`) each message's input is masked with the
// target pixel's window.  A batch of image pairs with one (side,
// space) table is the grid's third axis: the pair indexes the images,
// weights, windows, output planes and the ring, so a batch launches
// as many fronts as one pair.
//
// One map serves the five spaces: A/B (fstep 1, slope 1 or 2), V
// (slope 0: front t is column t, every row live) and the parity spaces
// PA/PB (slope 1, fstep 2: t = 2*col + r or 2*col + R-1-r, so a row is
// live only on fronts of its parity).  The TPU packs the parity
// spaces' live half-rows into lanes (pallas_fused._delta_roll); here a
// block whose row sits out a front leaves at once.
//
// What is not carried over is the TPU's blocking: the VMEM ring buffer,
// the DMA semaphores and the skewed image and weight copies.  The
// kernel indexes the unskewed images and the (N, R, C, 8) weights
// directly and writes the image-layout volume (Mp, R, C, L).  The
// recursion state of one front (Ml x R x L floats, 1.2 MB at the
// 700x500, L=151 main path) does not fit one SM's shared memory, so the
// last D fronts live in a global ring (hist/mins) that the 50 MB L2
// holds.  Fronts synchronise by kernel boundaries: the C entry point
// launches one small kernel per front on the caller's stream
// (T = fstep*(C-1) + slope*(R-1) + 1 launches per direction).
//
// Bound: the chain of T dependent launches (launch latency and the
// short per-front work; with FH, 4*ceil(log2 L) block barriers per
// message), plus one write (forward) or read-modify-write (backward)
// of the (Mp, R, C, L) float volume per pair (and one read of the
// per-pixel windows).  One block per (row, plane) with
// one thread per label keeps every label reduction (the all-invalid
// test, the per-pixel minimum, the FH doubling through shared memory)
// inside a block.  Every condition that guards a barrier (the row's
// front, the border rule, the recursion count) is the same for the
// whole block; the label padding (l >= L) is masked through values.
//
// Numerics follow the plain PyTorch version in cuda_fused.py operation
// for operation: build with --fmad=false and without fast math, so
// o + kappa*cc is not contracted and inf/NaN behave as IEEE says;
// minima keep NaN as torch.minimum does.
#include "mgm_device.cuh"

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One front of one launch.  The cost family (MODE), the potential (FH),
// whether edge weights come (W) and whether the launch has per-pixel
// windows or more than one pair (G) are template parameters, so each
// preset's instance carries no branch it does not take (fast_ad's is
// the AD, SGM, unweighted, constant-window, single-pair code alone) and
// the SGM ones have no barrier inside their message loop.  G is a
// template flag, not a run-time branch: as one, its index arithmetic
// took the SGM instances from 32 to 48 registers and cfg1's fronts
// 11 % longer on the H100.
template <int MODE, bool FH, bool W, bool G>
__device__ __forceinline__ void front(const WaveParams& p, int t,
                                      int slot_t) {
  __shared__ float buf[FH ? MGM_MAX_LABELS : 1];
  __shared__ float red[32];
  const int r = blockIdx.x;
  const int i = blockIdx.y;
  const int k = G ? (int)blockIdx.z : 0;  // image pair
  const int l = threadIdx.x;
  const int num = t - p.plane_a0[i] + p.plane_ssgn[i] * p.slope * r;
  // the whole block leaves together: the row has no pixel on front t
  if (num < 0 || num % p.fstep != 0) return;
  const int col = num / p.fstep;
  if (col >= p.C) return;
  const bool act = l < p.L;
  const int s = p.plane_side[i];
  const int n = G ? k * p.nsides + s : s;
  const size_t pix = ((size_t)n * p.R + r) * p.C + col;

  // ---- raw cost of this label, then truncation (pallas_fused.py:857)
  float e = p.tmax;
  const int q = col + p.plane_gmin[i] + l;  // right-image column
  if (act && q >= 0 && q < p.C) {
    const float raw = pointwise_cost(
        MODE, p.left, p.right, pix * p.nch,
        (((size_t)n * p.R + r) * p.C + q) * p.nch, p.nch, p.inv_nw);
    e = raw > p.tmax ? p.tmax : raw;  // min that keeps a NaN, like jnp
  }
  // the label window: the plane's, or this pixel's (-m/-M, the same
  // for the whole block: two loads a block, pallas_fused.py:860-862)
  int lo = p.plane_lo[i], hi = p.plane_hi[i];
  if (G && p.lo_px) {
    lo = p.lo_px[pix];
    hi = p.hi_px[pix];
  }
  const bool in_win = act && l >= lo && l <= hi;
  // all-invalid window -> 0 (mgm_costvolume.h:410-421)
  if (!__syncthreads_or(in_win && e < INFINITY)) e = 0.f;
  const float cc = in_win ? e : INFINITY;
  // update_cost2 halves each term (mgm_core.cc:83-84), only for the
  // unweighted SGM potential (pallas_fused.py:911)
  const bool halve = p.mgm == 2 && !FH && !W;
  // FH under per-pixel windows reads each message's input inside the
  // TARGET pixel's window only (pallas_fused.py:876-879, 902)
  const bool fh_in = (FH && G && p.fh_restrict) ? in_win : act;

  const int nrec = p.plane_nrec[i];
  // pair k's ring: (D + 1, Ml, R) rows after the earlier pairs' (one
  // base pointer a block; indexing a slot of all pairs took 48
  // registers where this takes 36)
  const size_t pair_rows = G ? (size_t)k * (p.D + 1) * p.Ml * p.R : 0;
  float* const hist = p.hist + pair_rows * p.L;
  float* const mins = p.mins + pair_rows;
  float sum = 0.f;
  for (int kr = 0; kr < nrec; ++kr) {
    const int m = p.plane_recs[i][kr];
    const int b = p.rec_border[m];
    bool interior = col >= ((b & 1) ? 1 : 0);
    if (b & 2) interior = interior && col <= p.C - 2;
    if (b & 4) interior = interior && r >= 1;
    if (b & 8) interior = interior && r <= p.R - 2;
    float nv = cc;
    // interior pixels read only neighbours inside the image, which
    // earlier fronts wrote; the others keep their cost (the select of
    // pallas_fused.py:932, never a multiply by a mask).  `interior` is
    // the block's, so the FH barriers are reached by every thread.
    if (interior) {
      float msum = 0.f, first = 0.f;
      // unrolled, so the deps' loads issue together (as a plain loop,
      // cfg1_tsgm4's fronts took 6 % longer on the H100)
#pragma unroll
      for (int j = 0; j < MGM_MAX_RANKS; ++j) {
        if (j >= p.mgm) break;
        const int ci = p.rec_ranks[m][j];
        const int lag = p.combo_lag[ci];
        const int tt = p.reverse ? t + lag : t - lag;
        const int slot = tt % (p.D + 1);
        const int rr = r - p.combo_roll[ci];
        const size_t row = ((size_t)slot * p.Ml + m) * p.R + rr;
        const float* h = hist + row * p.L;
        const float mk = mins[row];
        float p1w = p.p1, p2w = p.p2;
        if constexpr (W) {  // this dep's weight at the pixel updated
          const float d = p.w8[pix * 8 + p.rec_wch[m][j]];
          p1w = d * p.p1;
          p2w = d * p.p2;
        }
        float msg;
        if constexpr (FH) {
          msg = fh_msg(buf, fh_in ? h[l] : INFINITY, p.L, mk, p1w, p2w);
        } else {
          const float lk = act ? h[l] : INFINITY;
          const float lm = act && l > 0 ? h[l - 1] : INFINITY;
          const float lp = act && l < p.L - 1 ? h[l + 1] : INFINITY;
          msg = sgm_msg(lk, lm, lp, mk, p1w, p2w);
        }
        if (halve) {
          if (j == 0) first = msg;
          else msum = first * 0.5f + msg * 0.5f;
        } else {
          msum = j ? msum + msg : msg;
        }
      }
      if (p.mgm > 1 && !halve) msum = msum / (float)p.mgm;
      nv = cc + msum;
    }
    const size_t hrow = ((size_t)slot_t * p.Ml + m) * p.R + r;
    if (act) hist[hrow * p.L + l] = nv;
    // minimum over all labels of the new front, for the next fronts
    float mv = warp_min(act ? nv : INFINITY);
    if ((l & 31) == 0) red[l >> 5] = mv;
    __syncthreads();
    if (l == 0) {
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mv = nmin(mv, red[w]);
      mins[hrow] = mv;
    }
    __syncthreads();
    sum = kr ? sum + nv : nv;
  }
  if (!act) return;
  float o = nrec ? sum : 0.f;
  if (p.plane_fold[i]) o = o + p.kappa * cc;
  const size_t oi =
      G ? (size_t)(i - s) * p.npair + (size_t)k * p.nsides + s : (size_t)i;
  float* dst = p.out + ((oi * p.R + r) * p.C + col) * p.L + l;
  *dst = p.accumulate ? *dst + o : o;
}

// The FH instances keep to 40 registers, so 10 blocks of 160 threads
// fit an SM (8 at 48; __maxnreg__ needs nvcc 12.4 or later).  The SGM
// ones are left to the compiler: capped at 40 they spill.
template <int MODE, bool W, bool G>
__global__ void __maxnreg__(40) fh_front_kernel(const WaveParams p, int t,
                                                int slot_t) {
  front<MODE, true, W, G>(p, t, slot_t);
}

template <int MODE, bool W, bool G>
__global__ void sgm_front_kernel(const WaveParams p, int t, int slot_t) {
  front<MODE, false, W, G>(p, t, slot_t);
}

extern "C" int mgm_wave_params_size(void) { return (int)sizeof(WaveParams); }

template <int MODE, bool FH, bool W, bool G>
static int run_fronts(const WaveParams& p, cudaStream_t s) {
  const int T = p.fstep * (p.C - 1) + p.slope * (p.R - 1) + 1;
  const dim3 grid(p.R, p.Mp, p.npair);
  const int threads = (p.L + 31) / 32 * 32;
  for (int k = 0; k < T; ++k) {
    const int t = p.reverse ? T - 1 - k : k;
    if constexpr (FH)
      fh_front_kernel<MODE, W, G><<<grid, threads, 0, s>>>(p, t,
                                                           t % (p.D + 1));
    else
      sgm_front_kernel<MODE, W, G><<<grid, threads, 0, s>>>(p, t,
                                                            t % (p.D + 1));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

typedef int (*RunFronts)(const WaveParams&, cudaStream_t);

template <int MODE, bool G>
static RunFronts pick_g(bool fh, bool w) {
  if (fh)
    return w ? run_fronts<MODE, true, true, G>
             : run_fronts<MODE, true, false, G>;
  return w ? run_fronts<MODE, false, true, G>
           : run_fronts<MODE, false, false, G>;
}

template <int MODE>
static RunFronts pick(bool fh, bool w, bool g) {
  return g ? pick_g<MODE, true>(fh, w) : pick_g<MODE, false>(fh, w);
}

// Runs every front of one scan direction on `stream`; returns the first
// CUDA error (0 when all launches were accepted).
extern "C" int mgm_fused_wavefront(const WaveParams* params, void* stream) {
  const WaveParams p = *params;
  if (p.L < 1 || p.L > MGM_MAX_LABELS || p.Mp > MGM_MAX_PLANES ||
      p.Ml > MGM_MAX_RECS || p.mgm < 1 || p.mgm > MGM_MAX_RANKS ||
      p.fstep < 1 || p.slope < 0 || p.nch < 1 || p.npair < 1 ||
      p.npair > 65535 || p.nsides < 1 || p.Mp % p.nsides != 0 ||
      (p.lo_px == nullptr) != (p.hi_px == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool fh = p.use_fh != 0, w = p.w8 != nullptr;
  const bool g = p.lo_px != nullptr || p.npair > 1;
  RunFronts run;
  switch (p.mode) {
    case MGM_COST_AD: run = pick<MGM_COST_AD>(fh, w, g); break;
    case MGM_COST_SD: run = pick<MGM_COST_SD>(fh, w, g); break;
    case MGM_COST_CENSUS: run = pick<MGM_COST_CENSUS>(fh, w, g); break;
    case MGM_COST_BTAD: run = pick<MGM_COST_BTAD>(fh, w, g); break;
    case MGM_COST_BTSD: run = pick<MGM_COST_BTSD>(fh, w, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return run(p, (cudaStream_t)stream);
}
