// K5 on a band's entry points: a block of G fronts of a pass group on one
// rank's band of canonical rows, one launch a block (the kernel and its
// design: csrc/wavefront.cuh, template flag BAND; the blocks, halo ring
// and ship track: mgm_tpu_torch/parallel/halo.py).  Its own file, so that
// nvcc builds its 20 instances beside K5's.
#include "wavefront.cuh"

// The card's occupancy for a K5-band launch (k5_fit).
extern "C" int mgm_k5b_fit(const ScanParams* params, const K5Plan* kplan) {
  return k5_fit<true>(params, kplan);
}

// Runs the fronts p.t0 .. p.t0 + p.G - 1 of the band as one launch
// (k5_launch).
extern "C" int mgm_wavefront_band(const ScanParams* params,
                                  const K5Plan* kplan,
                                  unsigned long long* gdone,
                                  unsigned long long epoch, void* stream) {
  return k5_launch<true>(params, kplan, gdone, epoch, stream);
}
