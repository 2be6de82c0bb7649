// K1's instances for the census cost (csrc/fused_wavefront.cuh).
#include "fused_wavefront.cuh"

Launch k1_pick_census(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_CENSUS>(fh, w, g, L);
}
