// K1's instances for the btsd cost (csrc/fused_wavefront.cuh).
#include "fused_wavefront.cuh"

Launch k1_pick_btsd(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_BTSD>(fh, w, g, L);
}
