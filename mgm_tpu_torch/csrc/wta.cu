// K2: cross-space sum + windowed winner-take-all.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_fused.py:_wta_kernel
// (launched by unskew_wta_planes, pallas_fused.py:354).  K1 already
// writes image layout, so the TPU kernel's unskew (a dynamic lane roll
// per row) has nothing left to do here.  For every pixel of every side:
// s = the sum of the nspaces planes, left to right in the space order
// A, B, V, PA, PB (the JAX assembly's association), cand = s inside the
// label window where -inf < s < inf (NaN excluded) and +inf elsewhere,
// cost = min(cand), idx = the lowest label with cand == cost, and
// disp = gmin + idx.  A batch of pairs shares one table of sides: side
// n takes entry n % nsides.  An all-invalid window gives idx 0 and cost +inf.
// With `taps`, also the four raw sums S[oc-1 .. oc+2] that the subpixel
// fits read, (N, R, 4, C), oc = clip(idx, 1, max(L - 3, 1)).
//
// Bound: bytes, one read of the (nspaces * N, R, C, L) float volume.
// Design: the pixels of all sides, flattened (n, r, c), come in runs of
// `run` pixels (a multiple of 4, so a run's span of run * L floats in
// a space is contiguous and its length a multiple of 16 bytes).
// Persistent CTAs (a few a SM) walk the runs.  One producer warp brings
// each run's nspaces spans into a ring of `stages` shared-memory stages
// with 1-D bulk copies (cp.async.bulk, completing on the stage's
// mbarrier), so the next runs' loads are in flight while eight consumer
// warps reduce this one; a span's at most 3 + 3 elements beside the
// 16-byte boundaries (a plane whose start is not 16-byte aligned, the
// last run) go by ordinary loads of the producer before it arrives on
// the barrier.  The consumers sum the spaces into a shared-memory
// table of sums, a row of L words a pixel (L + 1 for an even L, so
// rows start in different banks), and release the stage at once; then
// a group of G lanes a pixel scans its labels (lane j takes labels j,
// j + G, ...), keeping the lowest label among equal minima, and a
// shuffle reduction over the group does the same; the group's lanes
// 0-3 read the taps from the table of sums.  disp and cost are written
// for consecutive pixels, the taps into the (N, R, 4, C) layout, split
// where a run crosses a row.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "mgm_kernels.h"
#include "smem_copy.cuh"

#define K2_CONSUMERS 256                  // eight consumer warps
#define K2_THREADS (K2_CONSUMERS + 32)    // and one producer warp

// shared memory of a CTA (cuda_fused.k2_plan mirrors it): 2 mbarriers
// a stage, the stages (nspaces spans of run * L floats each, 3 words of
// room for the span's offset from a 16-byte boundary), the table of sums
__host__ __device__ __forceinline__ int k2_span_words(int run, int L) {
  return (run * L + 3 + 3) & ~3;
}
__host__ __device__ __forceinline__ long long k2_bytes(int run, int stages,
                                                       int nspaces, int L) {
  return 16LL * stages +
         4LL * ((long long)stages * nspaces * k2_span_words(run, L) +
                (long long)run * (L | 1));
}

template <int NS>
__global__ void __launch_bounds__(K2_THREADS) wta_runs(const WtaParams p) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int S = p.stages, P = p.run, L = p.L;
  const int LS = L | 1;
  const int sw = k2_span_words(P, L);
  unsigned long long* full = (unsigned long long*)k2_smem;
  unsigned long long* empty = full + S;
  float* stage0 = (float*)(empty + S);
  float* sums = stage0 + (size_t)S * NS * sw;
  const long long npix = (long long)p.N * p.R * p.C;
  const long long plane = npix * L;  // a space's floats
  const int nruns = (int)((npix + P - 1) / P);
  // the volume's offset in floats from a 16-byte boundary
  const int mis = (int)((((size_t)p.vol) >> 2) & 3);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= K2_CONSUMERS) {
    // the producer: lane 0 of the last warp
    if (threadIdx.x != K2_CONSUMERS) return;
    int k = 0;
    for (int run = blockIdx.x; run < nruns; run += gridDim.x, ++k) {
      const int st = k % S, use = k / S;
      if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
      fence_proxy_async();
      const long long pix0 = (long long)run * P;
      const int n = (int)min((long long)P, npix - pix0) * L;
      unsigned bytes = 0;
#pragma unroll
      for (int si = 0; si < NS; ++si) {
        const long long g = (long long)si * plane + pix0 * L;
        const int s = (int)((mis + g) & 3);
        const Span sp = span_split(mis + g, n);
        float* dst = stage0 + (size_t)(st * NS + si) * sw + s;
        const float* src = p.vol + g;
        for (int e = 0; e < sp.head; ++e) dst[e] = src[e];
        for (int e = sp.head + sp.body; e < n; ++e) dst[e] = src[e];
        bytes += 4u * sp.body;
      }
      mbar_arrive_expect(&full[st], bytes);
#pragma unroll
      for (int si = 0; si < NS; ++si) {
        const long long g = (long long)si * plane + pix0 * L;
        const int s = (int)((mis + g) & 3);
        const Span sp = span_split(mis + g, n);
        if (sp.body)
          bulk_copy(stage0 + (size_t)(st * NS + si) * sw + s + sp.head,
                    p.vol + g + sp.head, 4u * sp.body, &full[st]);
      }
    }
    return;
  }

  // the consumers
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // phase 1's element walk: e = t + i * K2_CONSUMERS is pixel pp, label l
  const int dp = K2_CONSUMERS / L, dl = K2_CONSUMERS - dp * L;
  const int pp0 = t / L, l0 = t - pp0 * L;
  // phase 2: G lanes a pixel, 32 / G pixels a warp
  const int G = min(32, K2_CONSUMERS / P);
  const int j = lane % G;
  const int pw = warp * (32 / G) + lane / G;  // the lane's pixel of the run
  const long long RC = (long long)p.R * p.C;
  const int top = L - 3 > 1 ? L - 3 : 1;
  int k = 0;
  for (int run = blockIdx.x; run < nruns; run += gridDim.x, ++k) {
    const int st = k % S;
    mbar_wait(&full[st], (k / S) & 1);
    const long long pix0 = (long long)run * P;
    const int np = (int)min((long long)P, npix - pix0);
    const int n = np * L;
    // 1. sums[pp * LS + l] = the spaces' values, summed left to right
    const float* sp[NS];
#pragma unroll
    for (int si = 0; si < NS; ++si)
      sp[si] = stage0 + (size_t)(st * NS + si) * sw +
               (int)((mis + (long long)si * plane + pix0 * L) & 3);
    int pp = pp0, l = l0;
    for (int e = t; e < n; e += K2_CONSUMERS) {
      float s = sp[0][e];
#pragma unroll
      for (int si = 1; si < NS; ++si) s = s + sp[si][e];
      sums[pp * LS + l] = s;
      pp += dp;
      l += dl;
      if (l >= L) {
        l -= L;
        ++pp;
      }
    }
    bar_sync(1, K2_CONSUMERS);
    if (t == 0) mbar_arrive(&empty[st]);  // the stage is free again
    // 2. the windowed minimum of each pixel, a group of G lanes a pixel
    if (warp * (32 / G) < np) {
      const bool live = pw < np;
      const long long pix = pix0 + (live ? pw : 0);
      const int nn = (int)(pix / RC);
      const int sd = nn % p.nsides;
      const int lo = p.side_lo[sd], hi = p.side_hi[sd];
      const float* row = sums + (live ? pw : 0) * LS;
      float best = INFINITY;
      int bi = INT_MAX;
      if (live) {
        bi = j;
        for (int m = j; m < L; m += G) {
          const float s = row[m];
          const float cand =
              (m >= lo && m <= hi && s < INFINITY && s > -INFINITY) ? s
                                                                    : INFINITY;
          if (cand < best) {
            best = cand;
            bi = m;
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob < best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      // an all-invalid window: every lane's first label stood; lane 0's
      // is label 0
      if (live && j == 0) {
        p.disp[pix] = (float)(p.side_gmin[sd] + bi);
        p.cost[pix] = best;
      }
      if (live && p.taps && j < 4) {
        // tap j: the raw sum at clip(oc - 1 + j, 0, L - 1),
        // oc = clip(idx, 1, max(L - 3, 1)) (pallas_fused.py:228-240)
        const int oc = bi < 1 ? 1 : (bi > top ? top : bi);
        int pos = oc - 1 + j;
        pos = pos < 0 ? 0 : (pos > L - 1 ? L - 1 : pos);
        const long long rc = pix - (long long)nn * RC;
        const long long r = rc / p.C;
        p.taps[(((size_t)nn * p.R + r) * 4 + j) * p.C + (rc - r * p.C)] =
            row[pos];
      }
    }
    bar_sync(1, K2_CONSUMERS);  // the table of sums is free again
  }
}

extern "C" int mgm_wta_params_size(void) { return (int)sizeof(WtaParams); }

template <int NS>
static int launch(const WtaParams& p, long long nruns, cudaStream_t stream) {
  auto kern = wta_runs<NS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, K2_THREADS, p.smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)per_sm * sms;
  const long long ctas = nruns < most ? nruns : most;
  kern<<<(unsigned)ctas, K2_THREADS, p.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The persistent launch: as many CTAs as the card holds at once, at
// most one a run.  Returns the launch's CUDA error (0 if none).
extern "C" int mgm_wta(const WtaParams* params, void* stream) {
  const WtaParams p = *params;
  if (p.N < 1 || p.nsides < 1 || p.nsides > MGM_MAX_SIDES ||
      p.N % p.nsides != 0 || p.L < 1 || p.nspaces < 1 || p.nspaces > 5 ||
      p.R < 1 || p.C < 1 || p.run < 4 || p.run > 64 ||
      K2_CONSUMERS % p.run || p.stages < 1 ||
      (long long)p.smem < k2_bytes(p.run, p.stages, p.nspaces, p.L))
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)p.N * p.R * p.C;
  const long long nruns = (npix + p.run - 1) / p.run;
  if (nruns > INT_MAX || (long long)p.run * p.L > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.nspaces) {
    case 1: return launch<1>(p, nruns, s);
    case 2: return launch<2>(p, nruns, s);
    case 3: return launch<3>(p, nruns, s);
    case 4: return launch<4>(p, nruns, s);
    default: return launch<5>(p, nruns, s);
  }
}
