// K1's instances for the sd cost (csrc/fused_wavefront.cuh).
#include "fused_wavefront.cuh"

Launch k1_pick_sd(bool fh, bool w, bool g, int L) {
  return pick<MGM_COST_SD>(fh, w, g, L);
}
