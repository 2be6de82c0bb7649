// K4's instances for the ad cost: K1's kernel on a band
// (csrc/fused_wavefront.cuh, BAND; csrc/fused_block.cu).
#include "fused_wavefront.cuh"

Launch k4_pick_ad(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_AD, true>(fh, w, g, L);
}
