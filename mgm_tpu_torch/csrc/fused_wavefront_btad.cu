// K1's instances for the btad cost (csrc/fused_wavefront.cuh).
#include "fused_wavefront.cuh"

Launch k1_pick_btad(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_BTAD>(fh, w, g, L);
}
