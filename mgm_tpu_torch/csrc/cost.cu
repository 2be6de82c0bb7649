// K8: the finished dense cost volume of one image pair, in one pass.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_cost.py:_kernel (launched
// by pointwise_volume, pallas_cost.py:105) together with the
// elementwise tail that XLA fused onto it there (mgm_tpu/ops/cost.py
// build_cost_volume): for pixel (y, x) and label l, the cost between
// the left image's pixel and the right image's column q = x + gmin + l,
// clamped to the image (the TPU's edge-padded slice), for ad, sd,
// census (popcount of the XOR'd packed words, times 1/nwords) and
// btad/btsd (Birchfield-Tomasi from [I, Imin, Imax] channel blocks);
// then, as ops/cuda_cost.cost_volume_plain spells out: tmax where q
// lies off the image, the NaN-keeping minimum with tmax, 0 for every
// label of a pixel whose window [lo, hi] holds no finite cost, +inf
// outside the window.  The volume is written (H, W, L), labels
// fastest, into a caller's slice of a stack of volumes.
//
// Bound: bytes.  The (H, W, L) float write is the traffic (211 MB a
// side at 700x500, L = 151); the images and windows are read once.
// Design: a CTA owns a run of `tx` pixels of one row and all their
// labels.  It stages the run's left pixels, their windows and the right
// image's columns x0 + gmin .. x0 + tx - 1 + gmin + L - 1 (clamped;
// channel-planar) in shared memory with 4-byte cp.async, so each image
// element is read from L2 once a run and not once a label.  A warp
// takes K8_PX pixels at a time, their channels and windows in
// registers; a lane takes a right column j and the K8_PX elements that
// read it, (pp0 + i, j - pp0 - i) on a diagonal of the (pixel, label)
// plane, so the column's channels load once for K8_PX costs and the
// lanes' stores land on consecutive words.  The costs fill a
// shared-memory copy of the run's output span (tx * L contiguous
// floats, staged at the span's offset from a 16-byte boundary); a
// pixel's all-invalid flag is a warp vote; then the CTA stores the span
// with 16-byte stores (scalar stores for the at most 3 + 3 elements
// beside the 16-byte boundaries).  The family and the channel count
// are template parameters: no run-time family branch and no channel
// loop bound in the inner loop.  The costs' instructions pace it as
// much as the bytes do (PERF.md §6), so the inner loop has no branch
// (the label and window tests are unsigned range compares, the stores
// predicated) and the launch bound keeps K8_MIN_CTAS CTAs on an SM.
//
// Numerics follow the plain version bit for bit: pair_cost
// (mgm_device.cuh) sums the channels left to right as
// cuda_cost.pointwise_cost does, built with --fmad=false; nmin is
// torch.minimum's NaN-keeping minimum.
#include <math.h>

#include <type_traits>

#include "mgm_device.cuh"
#include "smem_copy.cuh"

#define K8_THREADS 256
#define K8_PX 4        // pixels a warp takes together (a column serves all)
#define K8_MIN_CTAS 5  // CTAs an SM holds: 48 registers a thread, no spill

// 32-bit words of shared memory a CTA uses (cuda_cost.k8_plan mirrors
// it): the staged output span, the right columns, the left pixels and
// each pixel's lo and hi.
__host__ __device__ __forceinline__ int k8_out_words(int tx, int L) {
  return (tx * L + 4 + 3) & ~3;
}
__host__ __device__ __forceinline__ long long k8_words(int tx, int L,
                                                       int nch) {
  return (long long)k8_out_words(tx, L) + (long long)nch * (tx + L - 1) +
         (long long)tx * nch + 2LL * tx;
}

template <int MODE, int NCH>
__global__ void __launch_bounds__(K8_THREADS, K8_MIN_CTAS)
    cost_volume_kernel(const CostParams p) {
  using T = typename std::conditional<MODE == MGM_COST_CENSUS, unsigned,
                                      float>::type;
  extern __shared__ __align__(16) unsigned char k8_smem[];
  const int nch = NCH ? NCH : p.nch;
  const int L = p.L, W = p.W, tx = p.tx;
  const int runs = (W + tx - 1) / tx;
  const int y = blockIdx.x / runs;
  const int x0 = (blockIdx.x - y * runs) * tx;
  const int np = min(tx, W - x0);  // the run's pixels
  const int span = tx + L - 1;     // staged right columns (the layout's)
  const int nq = np + L - 1;       // those the run reads
  float* outs = (float*)k8_smem;
  T* vs = (T*)(outs + k8_out_words(tx, L));
  T* us = vs + nch * span;
  int* los = (int*)(us + tx * nch);
  int* his = los + tx;

  // the run's inputs, 4-byte cp.async an element; right column j is
  // image column clamp(x0 + gmin + j)
  const size_t row = (size_t)y * W;
  const T* left = (const T*)p.left + (row + x0) * nch;
  const T* right = (const T*)p.right + row * nch;
  const int q0 = x0 + p.gmin;
  for (int i = threadIdx.x; i < nq * nch; i += K8_THREADS) {
    const int j = i / nch, c = i - j * nch;
    int q = q0 + j;
    q = q < 0 ? 0 : (q >= W ? W - 1 : q);
    cp_async4(&vs[c * span + j], &right[(size_t)q * nch + c]);
  }
  for (int i = threadIdx.x; i < np * nch; i += K8_THREADS)
    cp_async4(&us[i], &left[i]);
  for (int i = threadIdx.x; i < np; i += K8_THREADS) {
    cp_async4(&los[i], &p.lo[row + x0 + i]);
    cp_async4(&his[i], &p.hi[row + x0 + i]);
  }
  cp_async_wait_all();
  __syncthreads();

  // element e = pp * L + l of the run's span at outs[s + e]: s puts the
  // global 16-byte boundaries on shared-memory ones.  A warp takes
  // K8_PX pixels pp0 + i at a time, a lane a right column j and the
  // K8_PX elements that read it, (pp0 + i, j - pp0 - i): the column's
  // channels load once for them, the pixels' channels and windows once
  // for the warp, and the lanes store consecutive labels.
  const long long g0 = (long long)(row + x0) * L;
  const int s = (int)(((((size_t)p.out) >> 2) + g0) & 3);
  const float tmax = p.tmax;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pp0 = warp * K8_PX; pp0 < np; pp0 += K8_THREADS / 32 * K8_PX) {
    // per pixel i: its channels; its window as the columns j it covers,
    // (unsigned)(j - jlo) <= jw (an empty window: jlo = 2^31, jw = 0,
    // never); its labels, (unsigned)(j - pp0 - i) < lim (lim 0 past the
    // run's pixels); and where (pp0 + i, j - pp0 - i) lies: ob[i][j]
    T ul[K8_PX][NCH > 0 ? NCH : 1];
    unsigned jlo[K8_PX], jw[K8_PX], lim[K8_PX];
    float* ob[K8_PX];
#pragma unroll
    for (int i = 0; i < K8_PX; ++i) {
      const int pp = min(pp0 + i, np - 1);
      if constexpr (NCH > 0) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) ul[i][c] = us[pp * NCH + c];
      }
      const int lo = los[pp], hi = his[pp];
      jlo[i] = hi >= lo ? (unsigned)lo + (unsigned)(pp0 + i) : 0x80000000u;
      jw[i] = hi >= lo ? (unsigned)hi - (unsigned)lo : 0u;
      lim[i] = pp0 + i < np ? (unsigned)L : 0u;
      ob[i] = outs + s + (pp0 + i) * (L - 1);
    }
    unsigned anym = 0;  // bit i: pixel i has a finite cost in its window
    const int jend = min(pp0 + K8_PX, np) + L - 1;
    for (int j = pp0 + lane; j < jend; j += 32) {
      T vr[NCH > 0 ? NCH : 1];
      if constexpr (NCH > 0) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) vr[c] = vs[c * span + j];
      }
      const bool off = (unsigned)(q0 + j) >= (unsigned)W;
#pragma unroll
      for (int i = 0; i < K8_PX; ++i) {
        float v;
        if constexpr (NCH > 0)
          v = pair_cost<MODE, NCH>(ul[i], vr, 1, NCH, p.inv_nw);
        else
          v = pair_cost<MODE, 0>(us + (pp0 + i) * nch, vs + j, span, nch,
                                 p.inv_nw);
        v = nmin(off ? tmax : v, tmax);
        const bool inw = (unsigned)j - jlo[i] <= jw[i];
        const bool live = (unsigned)(j - pp0 - i) < lim[i];
        if (live && inw && fabsf(v) < INFINITY) anym |= 1u << i;
        if (live) ob[i][j] = inw ? v : INFINITY;
      }
    }
    // a pixel without a finite cost in its window: 0 inside it (rare)
    anym = __reduce_or_sync(0xffffffffu, anym);
#pragma unroll
    for (int i = 0; i < K8_PX; ++i) {
      const int pp = pp0 + i;
      if (pp >= np || (anym >> i & 1u)) continue;
      __syncwarp();
      for (int m = max(los[pp], 0) + lane; m <= min(his[pp], L - 1); m += 32)
        outs[s + pp * L + m] = 0.f;
    }
  }
  __syncthreads();

  // the span: scalar stores up to the first 16-byte boundary and after
  // the last, 16-byte stores between
  const int n = np * L;
  float* dst = p.out + g0;
  const Span sp = span_split(s, n);
  if (threadIdx.x < sp.head) dst[threadIdx.x] = outs[s + threadIdx.x];
  const float4* src4 = (const float4*)(outs + s + sp.head);
  float4* dst4 = (float4*)(dst + sp.head);
  for (int k = threadIdx.x; k < (sp.body >> 2); k += K8_THREADS)
    dst4[k] = src4[k];
  const int t0 = sp.head + sp.body;
  if (threadIdx.x < sp.tail)
    dst[t0 + threadIdx.x] = outs[s + t0 + threadIdx.x];
}

extern "C" int mgm_cost_params_size(void) { return (int)sizeof(CostParams); }

template <int MODE, int NCH>
static int launch(const CostParams& p, cudaStream_t stream) {
  auto kern = cost_volume_kernel<MODE, NCH>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)p.H * ((p.W + p.tx - 1) / p.tx);
  kern<<<(unsigned)blocks, K8_THREADS, p.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// One launch on `stream`; returns the launch's CUDA error (0 if none).
// The family and channel count pick the instance: ad/sd with 1 or 3
// channels, census with 1 or 2 words, BT with 1 or 3 channel blocks,
// and one instance a family for any other count.
extern "C" int mgm_cost_volume(const CostParams* params, void* stream) {
  const CostParams p = *params;
  const bool bt = p.mode == MGM_COST_BTAD || p.mode == MGM_COST_BTSD;
  if (p.H < 1 || p.W < 1 || p.L < 1 || p.nch < 1 || p.tx < 1 ||
      p.mode < MGM_COST_AD || p.mode > MGM_COST_BTSD || (bt && p.nch % 3) ||
      (long long)p.H * ((p.W + p.tx - 1) / p.tx) > 0x7fffffffLL ||
      (long long)p.tx * p.L > 0x7fffffffLL / 4 ||
      (long long)p.smem < 4 * k8_words(p.tx, p.L, p.nch))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.mode) {
    case MGM_COST_AD:
      return p.nch == 1 ? launch<MGM_COST_AD, 1>(p, s)
             : p.nch == 3 ? launch<MGM_COST_AD, 3>(p, s)
                          : launch<MGM_COST_AD, 0>(p, s);
    case MGM_COST_SD:
      return p.nch == 1 ? launch<MGM_COST_SD, 1>(p, s)
             : p.nch == 3 ? launch<MGM_COST_SD, 3>(p, s)
                          : launch<MGM_COST_SD, 0>(p, s);
    case MGM_COST_CENSUS:
      return p.nch == 1 ? launch<MGM_COST_CENSUS, 1>(p, s)
             : p.nch == 2 ? launch<MGM_COST_CENSUS, 2>(p, s)
                          : launch<MGM_COST_CENSUS, 0>(p, s);
    case MGM_COST_BTAD:
      return p.nch == 3 ? launch<MGM_COST_BTAD, 3>(p, s)
             : p.nch == 9 ? launch<MGM_COST_BTAD, 9>(p, s)
                          : launch<MGM_COST_BTAD, 0>(p, s);
    default:
      return p.nch == 3 ? launch<MGM_COST_BTSD, 3>(p, s)
             : p.nch == 9 ? launch<MGM_COST_BTSD, 9>(p, s)
                          : launch<MGM_COST_BTSD, 0>(p, s);
  }
}
