// K4's front: fused cost + the MGM recursion of one front of one scan
// direction over every (band row, plane) block of a launch, one thread
// a label.  It is the per-front design K1 had before its cluster
// redesign (csrc/fused_wavefront.cu, whose header comment describes the
// computation and its numerics); K4 (csrc/fused_block.cu) instantiates
// it, and chip_smoke.py holds K4's bands bitwise against K1's volume.
#pragma once

#include "mgm_device.cuh"

// The minimum of v over the block (every thread gets it); `red` holds
// one value a warp.  Every thread of the block must call it.
__device__ __forceinline__ float block_min(float v, float* red) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = nmin(m, red[w]);
  __syncthreads();
  return m;
}

// One front of one launch.  The cost family (MODE), the potential (FH),
// whether edge weights come (W) and whether the launch has per-pixel
// windows or more than one pair (G) are template parameters, so each
// preset's instance carries no branch it does not take (fast_ad's is
// the AD, SGM, unweighted, constant-window, single-pair code alone) and
// the SGM ones have no barrier inside their message loop.  G is a
// template flag, not a run-time branch: as one, its index arithmetic
// took the SGM instances from 32 to 48 registers and cfg1's fronts
// 11 % longer on the H100.
//
// The front runs on one rank's band of rows under row sharding: block
// row r is the band's local row (the ring's and, past out_off, the
// output's), image row b.r0 + r (the front map, the border rule and the
// images use image rows); a dep row outside the band reads the
// neighbour's halo track at step u - lag, or +inf without one; row
// b.ship_row writes its new front into the ship track.
template <int MODE, bool FH, bool W, bool G>
__device__ __forceinline__ void front(const WaveParams& p,
                                      const BandTail& b, int t, int slot_t,
                                      int u) {
  __shared__ float buf[FH ? MGM_MAX_LABELS : 1];
  __shared__ float red[32];
  const int r = blockIdx.x;              // the ring's row
  const int gr = b.r0 + r;               // the image row
  const int RR = b.Rl;                   // rows of the ring
  const int i = blockIdx.y;
  const int k = G ? (int)blockIdx.z : 0;  // image pair
  const int l = threadIdx.x;
  // rows above the image or past it (an apron, the band's padding)
  if (gr < 0 || gr >= p.R) return;
  const int num = t - p.plane_a0[i] + p.plane_ssgn[i] * p.slope * gr;
  // the whole block leaves together: the row has no pixel on front t
  if (num < 0 || num % p.fstep != 0) return;
  const int col = num / p.fstep;
  if (col >= p.C) return;
  const bool act = l < p.L;
  const int s = p.plane_side[i];
  const int n = G ? k * p.nsides + s : s;
  const size_t pix = ((size_t)n * p.R + gr) * p.C + col;

  // ---- raw cost of this label, then truncation (pallas_fused.py:857)
  float e = p.tmax;
  const int q = col + p.plane_gmin[i] + l;  // right-image column
  if (act && q >= 0 && q < p.C) {
    const float raw = pointwise_cost(
        MODE, p.left, p.right, pix * p.nch,
        (((size_t)n * p.R + gr) * p.C + q) * p.nch, p.nch, p.inv_nw);
    e = raw > p.tmax ? p.tmax : raw;  // min that keeps a NaN, like jnp
  }
  // the label window: the plane's, or this pixel's (-m/-M, the same
  // for the whole block: two loads a block, pallas_fused.py:860-862)
  int lo = p.plane_lo[i], hi = p.plane_hi[i];
  if (G && p.lo_px) {
    lo = p.lo_px[pix];
    hi = p.hi_px[pix];
  }
  const bool in_win = act && l >= lo && l <= hi;
  // all-invalid window -> 0 (mgm_costvolume.h:410-421)
  if (!__syncthreads_or(in_win && e < INFINITY)) e = 0.f;
  const float cc = in_win ? e : INFINITY;
  // update_cost2 halves each term (mgm_core.cc:83-84), only for the
  // unweighted SGM potential (pallas_fused.py:911)
  const bool halve = p.mgm == 2 && !FH && !W;
  // FH under per-pixel windows reads each message's input inside the
  // TARGET pixel's window only (pallas_fused.py:876-879, 902)
  const bool fh_in = (FH && G && p.fh_restrict) ? in_win : act;

  const int nrec = p.plane_nrec[i];
  // pair k's ring: (D + 1, Ml, R) rows after the earlier pairs' (one
  // base pointer a block; indexing a slot of all pairs took 48
  // registers where this takes 36)
  const size_t pair_rows = G ? (size_t)k * (p.D + 1) * p.Ml * RR : 0;
  float* const hist = p.hist + pair_rows * p.L;
  float* const mins = p.mins + pair_rows;
  float sum = 0.f;
  for (int kr = 0; kr < nrec; ++kr) {
    const int m = p.plane_recs[i][kr];
    const int bd = p.rec_border[m];
    bool interior = col >= ((bd & 1) ? 1 : 0);
    if (bd & 2) interior = interior && col <= p.C - 2;
    if (bd & 4) interior = interior && gr >= 1;
    if (bd & 8) interior = interior && gr <= p.R - 2;
    float nv = cc;
    // interior pixels read only neighbours inside the image, which
    // earlier fronts wrote; the others keep their cost (the select of
    // pallas_fused.py:932, never a multiply by a mask).  `interior` is
    // the block's, so the FH barriers are reached by every thread.
    if (interior) {
      float msum = 0.f, first = 0.f;
      // unrolled, so the deps' loads issue together (as a plain loop,
      // cfg1_tsgm4's fronts took 6 % longer on the H100)
#pragma unroll
      for (int j = 0; j < MGM_MAX_RANKS; ++j) {
        if (j >= p.mgm) break;
        const int ci = p.rec_ranks[m][j];
        const int lag = p.combo_lag[ci];
        const int tt = p.reverse ? t + lag : t - lag;
        const int slot = tt % (p.D + 1);
        const int rr = r - p.combo_roll[ci];
        const float* h;
        float mk;
        if (rr < 0 || rr >= RR) {
          // another band's row: the neighbour's shipped front, its
          // minimum recomputed (a minimum is exact in any order)
          if (b.halo) {
            h = b.halo + ((size_t)(u - lag + b.G) * p.Ml + m) * p.L;
            mk = block_min(act ? h[l] : INFINITY, red);
          } else {
            h = nullptr;
            mk = INFINITY;
          }
        } else {
          const size_t row = ((size_t)slot * p.Ml + m) * RR + rr;
          h = hist + row * p.L;
          mk = mins[row];
        }
        const bool hv = h != nullptr;
        float p1w = p.p1, p2w = p.p2;
        if constexpr (W) {  // this dep's weight at the pixel updated
          const float d = p.w8[pix * 8 + p.rec_wch[m][j]];
          p1w = d * p.p1;
          p2w = d * p.p2;
        }
        float msg;
        if constexpr (FH) {
          msg = fh_msg(buf, fh_in && hv ? h[l] : INFINITY, p.L, mk, p1w,
                       p2w);
        } else {
          const float lk = act && hv ? h[l] : INFINITY;
          const float lm = act && hv && l > 0 ? h[l - 1] : INFINITY;
          const float lp = act && hv && l < p.L - 1 ? h[l + 1] : INFINITY;
          msg = sgm_msg(lk, lm, lp, mk, p1w, p2w);
        }
        if (halve) {
          if (j == 0) first = msg;
          else msum = first * 0.5f + msg * 0.5f;
        } else {
          msum = j ? msum + msg : msg;
        }
      }
      if (p.mgm > 1 && !halve) msum = msum / (float)p.mgm;
      nv = cc + msum;
    }
    const size_t hrow = ((size_t)slot_t * p.Ml + m) * RR + r;
    if (act) hist[hrow * p.L + l] = nv;
    if (b.ship && r == b.ship_row && act)
      b.ship[((size_t)u * p.Ml + m) * p.L + l] = nv;
    // minimum over all labels of the new front, for the next fronts
    float mv = warp_min(act ? nv : INFINITY);
    if ((l & 31) == 0) red[l >> 5] = mv;
    __syncthreads();
    if (l == 0) {
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mv = nmin(mv, red[w]);
      mins[hrow] = mv;
    }
    __syncthreads();
    sum = kr ? sum + nv : nv;
  }
  if (!act) return;
  const int orow = r - b.out_off, OR = b.out_R;  // the output's row, rows
  if (orow < 0 || orow >= OR) return;
  float o = nrec ? sum : 0.f;
  if (p.plane_fold[i]) o = o + p.kappa * cc;
  const size_t oi =
      G ? (size_t)(i - s) * p.npair + (size_t)k * p.nsides + s : (size_t)i;
  float* dst = p.out + ((oi * OR + orow) * p.C + col) * p.L + l;
  *dst = p.accumulate ? *dst + o : o;
}

