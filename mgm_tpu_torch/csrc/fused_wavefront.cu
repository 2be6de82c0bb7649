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
#include "fused_front.cuh"

// The FH instances keep to 40 registers, so 10 blocks of 160 threads
// fit an SM (8 at 48; __maxnreg__ needs nvcc 12.4 or later).  The SGM
// ones are left to the compiler: capped at 40 they spill.
template <int MODE, bool W, bool G>
__global__ void __maxnreg__(40) fh_front_kernel(const WaveParams p, int t,
                                                int slot_t) {
  front<MODE, true, W, G, false>(p, BandTail{}, t, slot_t, 0);
}

template <int MODE, bool W, bool G>
__global__ void sgm_front_kernel(const WaveParams p, int t, int slot_t) {
  front<MODE, false, W, G, false>(p, BandTail{}, t, slot_t, 0);
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
