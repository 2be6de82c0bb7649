// K4: one block of K1's recursion on one rank's band of rows.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_fused.py:_block_kernel
// (launched by fused_block, pallas_fused.py:626), which the row-sharded
// pipeline (mgm_tpu/parallel/fused_shard.py) steps over G-front blocks.
// It is K1's kernel (csrc/fused_wavefront.cuh, whose design notes are in
// csrc/fused_wavefront.cu) with the template flag BAND: one launch a
// block, the fronts step0 .. step0 + nsteps - 1 stepped inside the
// kernel, one or more thread-block clusters a plane, rows in bands dealt
// to the CTAs in turn, a warp a row (two at L <= 48), labels across the
// lanes, the ring in global memory and rows synchronised by per-row
// counts of finished fronts; K1's arithmetic in the same order at every
// pixel, so a sharded run's volume is bitwise the single-device one's.
// What the band adds (BandTail, csrc/mgm_kernels.h):
//   - the launch's rows are the band's local rows (aprons included) that
//     lie in the image: local row x is image row r0 + x, and the front
//     map, the border rule and the images use image rows against the
//     image's R; rows above row 0 or past R are never run;
//   - the carried state is K1's own ring, (D + 1, Ml, Rl, L) and its
//     minima, kept by the caller from block to block (the TPU kernel
//     takes and returns hist/mins explicitly); the row counts start at
//     0 on front step0, since the stream orders the blocks;
//   - a dep row outside the band reads the neighbour's halo track, a
//     ring of two G-step tracks holding step s at entry s mod 2G,
//     complete before the launch (no wait), its minimum recomputed over
//     the row's lanes (a minimum is exact in any order), as
//     _block_kernel's `hidx = u -+ lag + 8` track (pallas_fused.py:
//     492-503); without a halo it reads +inf;
//   - row ship_row writes each front into the ship track (G, Ml, L) the
//     downstream band takes;
//   - the output holds local rows out_off .. out_off + out_R - 1.
// Bound: as K1's, the chain of the block's fronts, each a row's cost,
// messages and stores for one warp; the bytes are the band's share of
// K1's volume and images, plus the tracks.
#include "fused_wavefront.cuh"

// each cost family's band instances (fused_block_<family>.cu)
Launch k4_pick_ad(bool fh, bool w, bool g, int L);
Launch k4_pick_sd(bool fh, bool w, bool g, int L);
Launch k4_pick_census(bool fh, bool w, bool g, int L);
Launch k4_pick_btad(bool fh, bool w, bool g, int L);
Launch k4_pick_btsd(bool fh, bool w, bool g, int L);

extern "C" int mgm_band_params_size(void) { return (int)sizeof(BandParams); }

// The band instance for the block's parameters, after checking them and
// the plan (sized on the band's rows in the image) against the kernel's
// limits (nullptr: outside them).  One image pair.
static Launch k4_instance(const BandParams& bp, const K1Plan& plan) {
  const WaveParams& p = bp.w;
  const BandTail& b = bp.b;
  const int T = p.fstep * (p.C - 1) + p.slope * (p.R - 1) + 1;
  if (p.npair != 1 || b.Rl < 1 || b.out_R < 0 || b.G < p.D ||
      b.nsteps < 1 || b.nsteps > b.G || b.step0 < 0 || b.step0 >= T ||
      b.ship_row < -1 || b.ship_row >= b.Rl ||
      (b.ship == nullptr) != (b.ship_row < 0) ||
      !k1_params_ok(p, plan, RowMap<true>{p, b}.n()))
    return nullptr;
  const bool fh = p.use_fh != 0, w = p.w8 != nullptr;
  const bool g = p.lo_px != nullptr;
  switch (p.mode) {
    case MGM_COST_AD: return k4_pick_ad(fh, w, g, p.L);
    case MGM_COST_SD: return k4_pick_sd(fh, w, g, p.L);
    case MGM_COST_CENSUS: return k4_pick_census(fh, w, g, p.L);
    case MGM_COST_BTAD: return k4_pick_btad(fh, w, g, p.L);
    case MGM_COST_BTSD: return k4_pick_btsd(fh, w, g, p.L);
    default: return nullptr;
  }
}

// Runs the block as one cluster launch on `stream` with the plan's sizes
// (ops/cuda_fused.k4_plan); returns the CUDA error of the launch (0 when
// it was accepted), cudaErrorInvalidValue for parameters or a plan
// outside the kernel's limits, or MGM_ERR_NO_CLUSTER when the plan's
// clusters do not fit the card.  gdone, epoch: as for
// mgm_fused_wavefront, Mp * (the band's rows in the image) counts.
extern "C" int mgm_fused_block(const BandParams* params,
                               const K1Plan* kplan,
                               unsigned long long* gdone,
                               unsigned long long epoch, void* stream) {
  const Launch run = k4_instance(*params, *kplan);
  if (run == nullptr || (kplan->ncl > 1 && gdone == nullptr) ||
      epoch >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  return run(params->w, *kplan, params->b, gdone, epoch,
             (cudaStream_t)stream, nullptr);
}

// How many clusters of the plan's shape the card holds at once for the
// block's instance, or -1 for parameters or a plan outside the kernel's
// limits.
extern "C" int mgm_k4_fit(const BandParams* params, const K1Plan* kplan) {
  const Launch run = k4_instance(*params, *kplan);
  int fit = -1;
  if (run == nullptr ||
      run(params->w, *kplan, params->b, nullptr, 0, nullptr, &fit) != 0)
    return -1;
  return fit;
}
