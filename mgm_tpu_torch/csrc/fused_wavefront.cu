// K1: fused cost + MGM recursion, one scan direction, in one launch.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_fused.py:_kernel (launched
// by fused_wavefront, pallas_fused.py:1057).  It computes the same
// thing: for every front t of a skewed schedule (pixel (r, col) of a
// plane lies on front t = fstep*col + a0 - ssgn*slope*r), the cost of
// each label in flight from the two images (ad, sd, census on int32
// words, btad/btsd on [I, Imin, Imax] blocks: mgm_device.cuh's
// pointwise_cost, which K8 shares), the 1-4 coupled SGM or FH messages
// from the fronts t -+ lag, optionally with per-pixel edge weights, the
// update_cost2 quirk, the 1-pixel border rule, the optional kappa*CC
// overcount fold and the backward launch's accumulation onto the
// forward launch's output.  The label window is each plane's constant
// one, or each pixel's (-m/-M: (N, R, C) lo/hi planes), and with the
// truncated-linear potential under per-pixel windows (`fh_restrict`)
// each message's input is masked with the target pixel's window.  A
// batch of image pairs with one (side, space) table shares the launch:
// the pair indexes the images, weights, windows, output planes and the
// ring.  One map serves the five spaces: A/B (fstep 1, slope 1 or 2),
// V (slope 0: front t is column t, every row live) and the parity
// spaces PA/PB (slope 1, fstep 2: a row is live only on fronts of its
// parity).
//
// What is not carried over is the TPU's blocking (the VMEM ring, the
// DMA semaphores, the skewed image and weight copies): the kernel
// indexes the unskewed images and the (N, R, C, 8) weights directly and
// writes the image-layout volume (Mp, R, C, L).
//
// Design.  A unit is one recursion problem, (pair k, plane i): a plane
// reads only its own recursions' ring rows, so units never wait on one
// another.  A unit is one thread-block cluster of up to 16 CTAs (the
// non-portable size), or, where the card has room for two clusters a
// unit or more (a launch of one to four units), several clusters that
// the card holds together with every other unit's (the launch is
// refused otherwise).  Grid (cluster * ncl, Mp, npair), cluster
// (cluster, 1, 1); ops/cuda_fused.k1_plan picks the sizes.  The rows
// come in bands dealt to the unit's CTAs in turn, so that the rows live
// on a front, a contiguous range in the sloped spaces, spread over
// every CTA.  Every warp steps its rows through all T = fstep*(C-1) +
// slope*(R-1) + 1 fronts in the launch's order inside the kernel.  A
// one-cluster unit never waits on another cluster, so a launch with
// more clusters than the card holds (batches, tiles) runs them in
// waves.
//
// Synchronisation: a row's front reads only its own row and rows r -+ 1
// at earlier fronts, so instead of a barrier a front each row keeps a
// count of its finished fronts.  A row with a pixel on the front
// computes its costs, waits until rows r -+ 1 have finished the fronts
// it reads, runs its recursions, publishes the count (a release store:
// at CTA scope in its CTA's shared memory; at cluster scope where a
// neighbour lies in another CTA of the cluster, which reads it through
// distributed shared memory; and into a global array, at GPU scope and
// tagged with the launch's epoch, where a neighbour lies in another
// cluster), then writes its output; a row without a pixel publishes at
// once.  The ring stays in global memory, (npair, D + 1, Ml, R, L) rows
// and their minima (the 50 MB L2 holds it); another CTA's rows are read
// from L2 (ld.global.cg), the CTA's own through L1.  A cluster barrier a
// front (barrier.cluster.arrive.release / wait.acquire) compiles to
// MEMBAR.ALL.GPU and an L1 invalidation and holds every warp of the
// cluster in lockstep; on the H100 it was slower than the row counts
// (PERF.md §6).
//
// One warp computes the pixel of one row, or of two rows (L <= 48: a
// row a 16-lane segment, the segments in lockstep, a segment without a
// pixel computing on a clamped one and storing nothing).  The labels
// lie across the row's lanes, K to a lane in registers: label j*NL +
// sub-lane in slot j (coalesced ring and volume rows).  Every label
// reduction is a shuffle within the segment: the all-invalid vote (a
// ballot), the NaN-keeping minimum (exact in any order), the l -+ 1
// neighbours of the SGM message, and FH's min-plus doubling
// (ops/wavefront._fh_msg's steps s = 1, 2, 4, ... up, then down, each
// v[l] = nmin(v[l], v_old[l -+ s] + p1w*s), now a shuffle of each slot
// by s mod NL and a slot offset of s / NL, in the same order of steps,
// so every label sees the same operations; a recursion's deps double
// together, their loads issued first).
//
// Bound: the chain of T dependent fronts, each a row's cost, messages
// and stores for one warp, which shares its SM's issue slots with the
// CTA's other rows (the heaviest planes set the pace: cfg2's FH A
// planes run two recursions of three messages a row); the bytes are
// one write (forward) or read-modify-write (backward) of the (Mp, R,
// C, L) float volume a pair, and the images, weights and windows once.
//
// Instances: the cost family (MODE), FH, weights (W), and G (per-pixel
// windows or several pairs) are template flags (in the earlier per-front
// design a run-time G branch cost 11 % a front), and so are K,
// the labels a lane, and NL, the lanes a row: (16, 3) for L <= 48,
// (32, 2) to 64, (32, 5) to 160, (32, 6) to 192, (32, 32) to 1024
// (labels_a_lane), each with its CTA size limit (1024 threads and 64
// registers up to 6 labels a lane; 256 threads, 255 registers, at 32);
// 200 instances in all, each family's in a file of its own
// (fused_wavefront_<family>.cu) so that they compile in parallel; K4's
// 200 band instances (BAND, csrc/fused_block.cu) compile in
// fused_block_<family>.cu.
// ptxas (-Xptxas -v, sm_90a, in development builds on the H100 machine):
// the (16, 3) census SGM instance with pairs 64 registers and 48 bytes of
// stack, the (32, 5) ad SGM one 64 and 56, the (32, 5) census FH one
// 64 and 96-120 (spills; at 128 registers they spill nothing but hold
// one CTA an SM, which leaves too few SMs for four units of two
// clusters).
//
// Numerics follow the plain PyTorch version in cuda_fused.py operation
// for operation: build with --fmad=false and without fast math, so
// o + kappa*cc is not contracted and inf/NaN behave as IEEE says;
// minima keep NaN as torch.minimum does.
#include "fused_wavefront.cuh"

// each cost family's instances (fused_wavefront_<family>.cu)
Launch k1_pick_ad(bool fh, bool w, bool g, int L);
Launch k1_pick_sd(bool fh, bool w, bool g, int L);
Launch k1_pick_census(bool fh, bool w, bool g, int L);
Launch k1_pick_btad(bool fh, bool w, bool g, int L);
Launch k1_pick_btsd(bool fh, bool w, bool g, int L);

extern "C" int mgm_wave_params_size(void) { return (int)sizeof(WaveParams); }
extern "C" int mgm_k1_plan_size(void) { return (int)sizeof(K1Plan); }

// The instance for the launch's parameters, after checking them and the
// plan against the kernel's limits (nullptr: outside them).
static Launch k1_instance(const WaveParams& p, const K1Plan& plan) {
  if (!k1_params_ok(p, plan, p.R)) return nullptr;
  const bool fh = p.use_fh != 0, w = p.w8 != nullptr;
  const bool g = p.lo_px != nullptr || p.npair > 1;
  switch (p.mode) {
    case MGM_COST_AD: return k1_pick_ad(fh, w, g, p.L);
    case MGM_COST_SD: return k1_pick_sd(fh, w, g, p.L);
    case MGM_COST_CENSUS: return k1_pick_census(fh, w, g, p.L);
    case MGM_COST_BTAD: return k1_pick_btad(fh, w, g, p.L);
    case MGM_COST_BTSD: return k1_pick_btsd(fh, w, g, p.L);
    default: return nullptr;
  }
}

// Runs one scan direction as one cluster launch on `stream` with the
// plan's sizes (ops/cuda_fused.k1_plan); returns the CUDA error of the
// launch (0 when it was accepted), cudaErrorInvalidValue for parameters
// or a plan outside the kernel's limits, or MGM_ERR_NO_CLUSTER when
// the plan's clusters do not fit the card (at all, or, for a unit of
// several clusters, all of the launch's at once).  gdone: npair * Mp *
// R counts for the rows whose neighbours lie in another cluster (ncl >
// 1), tagged with `epoch`, which must exceed every earlier launch's on
// that buffer (below 2^32).
extern "C" int mgm_fused_wavefront(const WaveParams* params,
                                   const K1Plan* kplan,
                                   unsigned long long* gdone,
                                   unsigned long long epoch, void* stream) {
  const Launch run = k1_instance(*params, *kplan);
  if (run == nullptr || (kplan->ncl > 1 && gdone == nullptr) ||
      epoch >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  return run(*params, *kplan, BandTail{}, gdone, epoch,
             (cudaStream_t)stream, nullptr);
}

// How many clusters of the plan's shape the card holds at once for the
// launch's instance (k1_plan sizes a unit of several clusters by it),
// or -1 for parameters or a plan outside the kernel's limits.
extern "C" int mgm_k1_fit(const WaveParams* params, const K1Plan* kplan) {
  const Launch run = k1_instance(*params, *kplan);
  int fit = -1;
  if (run == nullptr ||
      run(*params, *kplan, BandTail{}, nullptr, 0, nullptr, &fit) != 0)
    return -1;
  return fit;
}
