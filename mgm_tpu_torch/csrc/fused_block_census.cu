// K4's instances for the census cost: K1's kernel on a band
// (csrc/fused_wavefront.cuh, BAND; csrc/fused_block.cu).
#include "fused_wavefront.cuh"

Launch k4_pick_census(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_CENSUS, true>(fh, w, g, L);
}
