// K1's instances for the ad cost (csrc/fused_wavefront.cuh).
#include "fused_wavefront.cuh"

Launch k1_pick_ad(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_AD>(fh, w, g, L);
}
