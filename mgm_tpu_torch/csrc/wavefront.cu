// K5's entry points: the dense MGM recursion over a canonical pass group
// in one launch (the kernel and its design: csrc/wavefront.cuh).
#include "wavefront.cuh"

extern "C" int mgm_scan_params_size(void) { return (int)sizeof(ScanParams); }
extern "C" int mgm_k5_plan_size(void) { return (int)sizeof(K5Plan); }

// The card's occupancy for a K5 launch (k5_fit).
extern "C" int mgm_k5_fit(const ScanParams* params, const K5Plan* kplan) {
  return k5_fit<false>(params, kplan);
}

// Runs every front of one pass group as one launch (k5_launch).
extern "C" int mgm_wavefront_scan(const ScanParams* params,
                                  const K5Plan* kplan,
                                  unsigned long long* gdone,
                                  unsigned long long epoch, void* stream) {
  return k5_launch<false>(params, kplan, gdone, epoch, stream);
}
