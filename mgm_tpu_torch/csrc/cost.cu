// K8: the raw pointwise cost volume of one image pair.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_cost.py:_kernel (launched
// by pointwise_volume, pallas_cost.py:105).  It computes the same
// thing: for pixel (y, x) and label l, the cost between the left
// image's pixel and the right image's column q = x + gmin + l, clamped
// to the image (the TPU's edge-padded slice), for ad, sd, census
// (popcount of the XOR'd packed words, times 1/nwords) and btad/btsd
// (Birchfield-Tomasi from [I, Imin, Imax] channel blocks).  Truncation,
// the out-of-image labels and the label windows stay with the
// tensor code of build_cost_volume (ops/cost.py), as in the JAX package.
//
// What is not carried over is the TPU's layout: its (L, W, H) slabs
// with rows in lanes, the VMEM-resident image slabs and the row
// chunking.  The volume is written (H, W, L), labels fastest.
//
// Bound: bytes.  The (H, W, L) float write is the traffic (211 MB a
// side at 700x500, L = 151); the images are read ~L times but stay in
// L1/L2.  One thread per (pixel, label), consecutive threads on
// consecutive labels of a pixel, so the stores coalesce and the right
// image's reads walk consecutive columns.
//
// Numerics follow the plain PyTorch version in cuda_cost.py: the cost
// of a (pixel, label) pair is mgm_device.cuh's pointwise_cost, which K1
// also computes in flight (channels summed left to right, no d*d + acc
// contraction under --fmad=false, a NaN-keeping minimum for BT).
#include "mgm_device.cuh"

__global__ void cost_kernel(const CostParams p) {
  const int y = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // x * L + l
  if (e >= p.W * p.L) return;
  const int x = e / p.L;
  const int l = e - x * p.L;
  int q = x + p.gmin + l;
  q = q < 0 ? 0 : (q >= p.W ? p.W - 1 : q);
  p.out[(size_t)y * p.W * p.L + e] = pointwise_cost(
      p.mode, p.left, p.right, ((size_t)y * p.W + x) * p.nch,
      ((size_t)y * p.W + q) * p.nch, p.nch, p.inv_nw);
}

extern "C" int mgm_cost_params_size(void) { return (int)sizeof(CostParams); }

// One launch on `stream`; returns the launch's CUDA error (0 if none).
extern "C" int mgm_pointwise_volume(const CostParams* params, void* stream) {
  const CostParams p = *params;
  if (p.H < 1 || p.H > 65535 || p.W < 1 || p.L < 1 || p.nch < 1 ||
      p.mode < MGM_COST_AD || p.mode > MGM_COST_BTSD ||
      (long long)p.W * p.L > 0x7fffffffLL - 256)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((p.W * p.L + threads - 1) / threads, p.H);
  cost_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
