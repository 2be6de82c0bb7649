// K4: one block of K1's recursion on one rank's band of rows.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_fused.py:_block_kernel
// (launched by fused_block, pallas_fused.py:626), which the row-sharded
// pipeline (mgm_tpu/parallel/fused_shard.py) steps over G-front blocks.
// Here it is the per-front design K1 had before its cluster redesign
// (csrc/fused_front.cuh): K1's arithmetic in the same order at every
// pixel, so a sharded run's volume is bitwise the single-device one's.
// What the band adds:
//   - the grid's rows are the band's local rows (plus aprons); the
//     front map, the border rule and the images use image rows r0 + r
//     against the image's R, and rows outside [0, R) leave at once;
//   - the carried state is K1's own ring, (D + 1, Ml, Rl, L) and its
//     minima, kept by the caller from block to block (the TPU kernel
//     takes and returns hist/mins explicitly);
//   - a dep row outside the band reads the neighbour's halo track, the
//     row it shipped at step u - lag of this block (index u - lag + G),
//     its minimum recomputed by a block reduction, as _block_kernel's
//     `hidx = u -+ lag + 8` track (pallas_fused.py:492-503);
//   - row ship_row writes each step's new front into the ship track
//     (G, Ml, L) the downstream band takes;
//   - the output holds local rows out_off .. out_off + out_R - 1.
// One front kernel a step, nsteps of them on the caller's stream.
#include "fused_front.cuh"

template <int MODE, bool FH, bool W, bool G>
__global__ void band_front_kernel(const BandParams bp, int t, int slot_t,
                                  int u) {
  front<MODE, FH, W, G>(bp.w, bp.b, t, slot_t, u);
}

extern "C" int mgm_band_params_size(void) { return (int)sizeof(BandParams); }

template <int MODE, bool FH, bool W, bool G>
static int run_block(const BandParams& bp, cudaStream_t s) {
  const WaveParams& p = bp.w;
  const int T = p.fstep * (p.C - 1) + p.slope * (p.R - 1) + 1;
  const dim3 grid(bp.b.Rl, p.Mp, 1);
  const int threads = (p.L + 31) / 32 * 32;
  for (int u = 0; u < bp.b.nsteps; ++u) {
    const int k = bp.b.step0 + u;
    if (k >= T) break;
    const int t = p.reverse ? T - 1 - k : k;
    band_front_kernel<MODE, FH, W, G><<<grid, threads, 0, s>>>(
        bp, t, t % (p.D + 1), u);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

typedef int (*RunBlock)(const BandParams&, cudaStream_t);

template <int MODE, bool G>
static RunBlock pick_block_g(bool fh, bool w) {
  if (fh)
    return w ? run_block<MODE, true, true, G> : run_block<MODE, true, false, G>;
  return w ? run_block<MODE, false, true, G> : run_block<MODE, false, false, G>;
}

template <int MODE>
static RunBlock pick_block(bool fh, bool w, bool g) {
  return g ? pick_block_g<MODE, true>(fh, w) : pick_block_g<MODE, false>(fh, w);
}

// Runs the block's steps on `stream`; returns the first CUDA error (0
// when all launches were accepted).  One image pair (npair 1).
extern "C" int mgm_fused_block(const BandParams* params, void* stream) {
  const BandParams bp = *params;
  const WaveParams& p = bp.w;
  const BandTail& b = bp.b;
  if (p.L < 1 || p.L > MGM_MAX_LABELS || p.Mp > MGM_MAX_PLANES ||
      p.Ml > MGM_MAX_RECS || p.mgm < 1 || p.mgm > MGM_MAX_RANKS ||
      p.fstep < 1 || p.slope < 0 || p.nch < 1 || p.npair != 1 ||
      p.nsides < 1 || p.Mp % p.nsides != 0 ||
      (p.lo_px == nullptr) != (p.hi_px == nullptr) || b.Rl < 1 ||
      b.Rl > 65535 || b.out_R < 0 || b.G < p.D || b.nsteps < 1 ||
      b.nsteps > b.G || b.step0 < 0 || b.ship_row < -1 ||
      b.ship_row >= b.Rl || (b.ship == nullptr) != (b.ship_row < 0))
    return (int)cudaErrorInvalidValue;
  const bool fh = p.use_fh != 0, w = p.w8 != nullptr;
  const bool g = p.lo_px != nullptr;
  RunBlock run;
  switch (p.mode) {
    case MGM_COST_AD: run = pick_block<MGM_COST_AD>(fh, w, g); break;
    case MGM_COST_SD: run = pick_block<MGM_COST_SD>(fh, w, g); break;
    case MGM_COST_CENSUS: run = pick_block<MGM_COST_CENSUS>(fh, w, g); break;
    case MGM_COST_BTAD: run = pick_block<MGM_COST_BTAD>(fh, w, g); break;
    case MGM_COST_BTSD: run = pick_block<MGM_COST_BTSD>(fh, w, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return run(bp, (cudaStream_t)stream);
}
