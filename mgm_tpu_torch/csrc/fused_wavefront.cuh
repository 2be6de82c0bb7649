// K1's kernel (csrc/fused_wavefront.cu describes it) and its launch,
// templated on the cost family, FH, weights, G, the labels a lane and
// the lanes a row.
#pragma once

#include <cooperative_groups.h>

#include "mgm_device.cuh"

#define FULL_MASK 0xffffffffu
// the launch's cluster size fits no SM group of the card
#define MGM_ERR_NO_CLUSTER (-1)

// K1's instances: the lanes of a row (a warp holds 32 / NL rows, one a
// lane segment) and the labels a lane (K) for L labels: (16, 3) up to
// L = 48, (32, 2) to 64, (32, 5) to 160, (32, 6) to 192, (32, 32) to
// 1024 (MGM_MAX_LABELS).
__host__ __device__ constexpr int k1_lanes(int L) {
  return L <= 48 ? 3 : L <= 64 ? 2 : L <= 160 ? 5 : L <= 192 ? 6 : 32;
}

// The CTA size limit of the instance with K labels a lane: 64 registers
// a thread up to 6 labels a lane, 255 at 32.
__host__ __device__ constexpr int k1_max_threads(int K) {
  return K <= 6 ? 1024 : 256;
}

// A CTA's warps for `rows` local rows: a warp for each 32 / NL of them,
// as far as the instance's CTA size allows.
__host__ __device__ constexpr int k1_warps(int rows, int K, int NL) {
  return (rows + 32 / NL - 1) / (32 / NL) < k1_max_threads(K) / 32
             ? (rows + 32 / NL - 1) / (32 / NL)
             : k1_max_threads(K) / 32;
}

// A row's count of finished fronts: the first lane of its segment
// stores it with release semantics after the row's ring writes (CTA
// scope; cluster scope for a row with a neighbour in another CTA, which
// reads the count through distributed shared memory); a reader spins on
// it with acquire semantics at the same scope, then reads that row
// through L1 within the CTA, from L2 (ld.global.cg) otherwise.
__device__ __forceinline__ void publish_cta(int* done, int u) {
  asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(done), "r"(u)
               : "memory");
}

__device__ __forceinline__ void publish_cluster(int* done, int u) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(done), "r"(u)
               : "memory");
}

__device__ __forceinline__ void wait_cta(const int* done, int u) {
  for (;;) {
    int d;
    asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(d) : "l"(done)
                 : "memory");
    if (d >= u) return;
    __nanosleep(32);
  }
}

__device__ __forceinline__ void wait_cluster(const int* done, int u) {
  for (;;) {
    int d;
    asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(d) : "l"(done)
                 : "memory");
    if (d >= u) return;
    __nanosleep(32);
  }
}

// A count in the global array, for a neighbour row in another cluster
// (L2; release/acquire at GPU scope).
__device__ __forceinline__ void publish_gpu(unsigned long long* done,
                                            unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(done), "l"(v)
               : "memory");
}

__device__ __forceinline__ void wait_gpu(const unsigned long long* done,
                                         unsigned long long v) {
  for (;;) {
    unsigned long long d;
    asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(d) : "l"(done)
                 : "memory");
    if (d >= v) return;
    __nanosleep(32);
  }
}

// The NaN-keeping minimum of v over each NL-lane segment of the warp
// (every lane gets its segment's).
template <int NL>
__device__ __forceinline__ float seg_min(float v) {
#pragma unroll
  for (int off = NL / 2; off > 0; off >>= 1)
    v = nmin(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// Slot `idx` of v (after unrolling a constant) read from lane `src` of
// this lane's NL-lane segment (B != 0) or from this lane; +inf outside
// the slots.
template <int K, int NL, int B>
__device__ __forceinline__ float slot_from(const float (&v)[K], int idx,
                                           int src) {
  if (idx < 0 || idx >= K) return INFINITY;
  return B ? __shfl_sync(FULL_MASK, v[idx], src, NL) : v[idx];
}

// One upward FH step of shift S: v[l] = nmin(v[l], v_old[l - S] + c),
// +inf below label 0.  Label l = i*NL + sl (sl: the lane within its
// segment); l - S lies in slot i - A at sub-lane sl - B, or for sub-lanes
// < B in slot i - A - 1; slots descend, so every read sees an old
// value, and each slot is shuffled once.
template <int K, int NL, int S>
__device__ __forceinline__ void fh_up_step(float (&v)[K], float c, int sl) {
  constexpr int A = S / NL, B = S % NL;
  const int src = (sl - B) & (NL - 1);
  const bool same = sl >= B;
  float carry = slot_from<K, NL, B>(v, K - 1 - A, src);
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    const float x1 = slot_from<K, NL, B>(v, i - A - 1, src);
    v[i] = nmin(v[i], (same ? carry : x1) + c);
    carry = x1;
  }
}

// One downward step: v[l] = nmin(v[l], v_old[l + S] + c); labels >= L
// must hold +inf (they read as fh_msg's "l + s >= L").
template <int K, int NL, int S>
__device__ __forceinline__ void fh_down_step(float (&v)[K], float c,
                                             int sl) {
  constexpr int A = S / NL, B = S % NL;
  const int src = (sl + B) & (NL - 1);
  const bool same = sl + B < NL;
  float carry = slot_from<K, NL, B>(v, A, src);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float x1 = slot_from<K, NL, B>(v, i + A + 1, src);
    v[i] = nmin(v[i], (same ? carry : x1) + c);
    carry = x1;
  }
}

// fh_msg's doubling of the first mgm deps' rows v[j] at once (their
// steps interleave), s = 2^E while s < L, p1w[j] * (float)s as there.
template <int K, int NL, int E = 0>
__device__ __forceinline__ void fh_up(float (&v)[MGM_MAX_RANKS][K],
                                      const float (&p1w)[MGM_MAX_RANKS],
                                      int mgm, int L, int sl) {
  constexpr int S = 1 << E;
  if constexpr (S < NL * K) {
    if (S >= L) return;
#pragma unroll
    for (int j = 0; j < MGM_MAX_RANKS; ++j)
      if (j < mgm) fh_up_step<K, NL, S>(v[j], p1w[j] * (float)S, sl);
    fh_up<K, NL, E + 1>(v, p1w, mgm, L, sl);
  }
}

template <int K, int NL, int E = 0>
__device__ __forceinline__ void fh_down(float (&v)[MGM_MAX_RANKS][K],
                                        const float (&p1w)[MGM_MAX_RANKS],
                                        int mgm, int L, int sl) {
  constexpr int S = 1 << E;
  if constexpr (S < NL * K) {
    if (S >= L) return;
#pragma unroll
    for (int j = 0; j < MGM_MAX_RANKS; ++j)
      if (j < mgm) fh_down_step<K, NL, S>(v[j], p1w[j] * (float)S, sl);
    fh_down<K, NL, E + 1>(v, p1w, mgm, L, sl);
  }
}

// The row's raw costs of its K label slots: pointwise_cost's terms
// (mgm_device.cuh) summed in its order, a channel at a time over the
// slots, so the left pixel's channels load once and a channel's loads
// of all slots issue together.  vo[j]: slot j's right pixel, in
// elements from the start of the right image's row.
template <int MODE, int K>
__device__ __forceinline__ void slot_costs(const WaveParams& p, size_t up,
                                           size_t vrow, const int (&vo)[K],
                                           int nk, float (&raw)[K]) {
  const int nch = p.nch;
  if constexpr (MODE == MGM_COST_CENSUS) {
    const unsigned* u = (const unsigned*)p.left + up;
    const unsigned* v = (const unsigned*)p.right + vrow;
    int bits[K];
#pragma unroll
    for (int j = 0; j < K; ++j) bits[j] = 0;
    for (int c = 0; c < nch; ++c) {
      const unsigned uw = u[c];
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (K <= 6 || j < nk) bits[j] += __popc(uw ^ v[vo[j] + c]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) raw[j] = (float)bits[j] * p.inv_nw;
  } else if constexpr (MODE == MGM_COST_AD || MODE == MGM_COST_SD) {
    const float* u = (const float*)p.left + up;
    const float* v = (const float*)p.right + vrow;
    for (int c = 0; c < nch; ++c) {
      const float uc = u[c];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (K > 6 && j >= nk) break;
        const float d = ad_term(MODE, uc, v[vo[j] + c]);
        raw[j] = c ? raw[j] + d : d;
      }
    }
  } else {
    const float* u = (const float*)p.left + up;
    const float* v = (const float*)p.right + vrow;
    const int C = nch / 3;
    for (int c = 0; c < C; ++c) {
      const float il = u[c], umin = u[C + c], umax = u[2 * C + c];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (K > 6 && j >= nk) break;
        const float* vj = v + vo[j];
        const float bt =
            bt_term(MODE, il, umin, umax, vj[c], vj[C + c], vj[2 * C + c]);
        raw[j] = c ? raw[j] + bt : bt;
      }
    }
  }
}

// Coupled dep j of recursion m at pixel (r, pix), ring slot slot_t, for
// a lane whose pixel is interior (`act`; +inf otherwise): its front's
// row (label s*NL + sl in v[s]; `win` bit s set where that label lies in
// the pixel's window, the FH input under fh_restrict), the row's minimum
// and the dep's P1, P2 (weighted at the pixel).
template <bool W, int K, int NL>
__device__ __forceinline__ void load_dep(const WaveParams& p,
                                         const float* hist, const float* mins,
                                         int m, int j, int slot_t, int r,
                                         bool mine_up, bool mine_dn,
                                         size_t pix, bool act, unsigned win,
                                         bool restrict_in, int nk, int sl,
                                         float (&v)[K], float& mk,
                                         float& p1w, float& p2w) {
  p1w = p.p1;
  p2w = p.p2;
  if (NL < 32) {  // lockstep segments: a non-interior row loads nothing
#pragma unroll
    for (int s = 0; s < K; ++s) v[s] = INFINITY;
    mk = INFINITY;
    if (!act) return;
  }
  const int ci = p.rec_ranks[m][j];
  const int lag = p.combo_lag[ci];
  // the slot of front t -+ lag: (t -+ lag) mod (D + 1), lag <= D
  int slot = p.reverse ? slot_t + lag : slot_t - lag;
  if (slot < 0) slot += p.D + 1;
  if (slot > p.D) slot -= p.D + 1;
  const int roll = p.combo_roll[ci];
  const size_t row = ((size_t)slot * p.Ml + m) * p.R + (r - roll);
  const float* h = hist + row * p.L;
  // a row of this CTA: written on this SM, read through L1; another
  // CTA's: written on another SM, read from L2 (ld.global.cg)
  const bool mine = roll == 0 || (roll > 0 ? mine_up : mine_dn);
  mk = mine ? mins[row] : __ldcg(mins + row);
  if constexpr (W) {  // this dep's weight at the pixel updated
    const float d = p.w8[pix * 8 + p.rec_wch[m][j]];
    p1w = d * p.p1;
    p2w = d * p.p2;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int l = s * NL + sl;
    const bool in = restrict_in ? ((win >> s) & 1u) != 0 : l < p.L;
    v[s] = INFINITY;
    if ((K <= 6 || s < nk) && in) v[s] = mine ? h[l] : __ldcg(h + l);
  }
}

// Message j folded into acc (the first message, a sum, or
// update_cost2's halves): FH from dep j's doubled row v, SGM from its
// loaded row.
template <bool FH, int K, int NL>
__device__ __forceinline__ void fold_message(const float (&v)[K], float mk,
                                             float p1w, float p2w, int j,
                                             bool halve, int nk, int sl,
                                             float (&acc)[K]) {
  // SGM: the l - 1 neighbour is the previous sub-lane's (sub-lane 0: the
  // slot below's last), the l + 1 one the next sub-lane's (the last: the
  // slot above's sub-lane 0)
  float below = INFINITY, above = INFINITY;
  if constexpr (!FH)
    above = __shfl_sync(FULL_MASK, v[0], (sl + 1) & (NL - 1), NL);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (K > 6 && s >= nk) break;  // the 32-label instance's idle slots
    float msg;
    if constexpr (FH) {
      msg = nmin(v[s], mk + p2w) - mk;
    } else {
      const float dn =
          __shfl_sync(FULL_MASK, v[s], (sl + NL - 1) & (NL - 1), NL);
      const float up = s + 1 < K
          ? __shfl_sync(FULL_MASK, v[s + 1 < K ? s + 1 : 0],
                        (sl + 1) & (NL - 1), NL)
          : INFINITY;
      msg = sgm_msg(v[s], sl >= 1 ? dn : below, sl <= NL - 2 ? above : up,
                    mk, p1w, p2w);
      below = dn;
      above = up;
    }
    if (j == 0)
      acc[s] = msg;
    else if (halve)  // update_cost2 (mgm_core.cc:83-84)
      acc[s] = acc[s] * 0.5f + msg * 0.5f;
    else
      acc[s] = acc[s] + msg;
  }
}

// One front of the warp's rows: each NL-lane segment takes row r (r < 0:
// none) of plane i, pair k on front t (ring slot slot_t).  A row with a
// pixel on the front computes its costs, wait()s for the neighbours'
// earlier fronts, writes each recursion's new front into the ring (and
// its minimum), publish()es (the neighbours may go on), then writes the
// plane's output; a row without one publishes at once (it reads and
// writes nothing on this front, so it need not wait).  The segments run
// in lockstep (every shuffle is the whole warp's); a segment whose row
// has no pixel computes on a clamped one and stores nothing.
// Slots holding a label of some lane are not tested (K <= 6: the
// instance fits L), so their loads issue together; the 32-label
// instance skips its idle slots.
template <int MODE, bool FH, bool W, bool G, int K, int NL, class Wait,
          class Publish>
__device__ __forceinline__ void row_front(const WaveParams& p, float* hist,
                                          float* mins, int i, int k, int r,
                                          bool mine_up, bool mine_dn, int t,
                                          int slot_t, int sl, Wait&& wait,
                                          Publish&& publish) {
  constexpr unsigned SEG = NL == 32 ? FULL_MASK : (1u << NL) - 1u;
  const int seg0 = (threadIdx.x & 31) & ~(NL - 1);  // segment's first lane
  int col = 0;
  bool live = false;
  if (r >= 0) {
    const int num = t - p.plane_a0[i] + p.plane_ssgn[i] * p.slope * r;
    col = p.fstep == 1 ? num : num >> 1;  // fstep is 1 or 2
    live = num >= 0 && !(num & (p.fstep - 1)) && col < p.C;
  }
  // (one row a warp: `live` is the warp's, and the masks below fold away)
  if (NL == 32 ? !live : !__any_sync(FULL_MASK, live)) {
    publish();  // no row of the warp has a pixel
    return;
  }
  if (NL == 32) live = true;
  if (!live) col = 0;  // a clamped pixel, nothing stored
  const int rc = live ? r : 0;
  const int nk = (p.L + NL - 1) / NL;  // slots holding a label
  const int s = p.plane_side[i];
  const int n = G ? k * p.nsides + s : s;
  const size_t prow = (size_t)n * p.R + rc;
  const size_t pix = prow * p.C + col;
  const size_t oi =
      G ? (size_t)(i - s) * p.npair + (size_t)k * p.nsides + s : (size_t)i;
  float* const out = p.out + ((oi * p.R + rc) * p.C + col) * p.L;
  // the row's next pixel (col -+ 1) accumulates on the next front of
  // its own: fetch its forward-launch sums into L2 now
  const int ncol = p.reverse ? col - 1 : col + 1;
  if (live && p.accumulate && ncol >= 0 && ncol < p.C) {
    const float* nxt = out + (ncol - col) * p.L;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (K > 6 && j >= nk) break;
      if (j * NL + sl < p.L)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nxt + j * NL + sl));
    }
  }

  // ---- raw cost of each label, then truncation (pallas_fused.py:857)
  // and the label window: the plane's, or this pixel's (-m/-M).  Lanes
  // off the right image read a clamped column and keep tmax.
  int lo = p.plane_lo[i], hi = p.plane_hi[i];
  if (G && p.lo_px) {
    lo = p.lo_px[pix];
    hi = p.hi_px[pix];
  }
  const int q0 = col + p.plane_gmin[i] + sl;  // slot 0's right column
  int vo[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int q = q0 + j * NL;
    vo[j] = (q < 0 ? 0 : (q >= p.C ? p.C - 1 : q)) * p.nch;
  }
  float cc[K];
  slot_costs<MODE, K>(p, pix * p.nch, prow * p.C * p.nch, vo, nk, cc);
  unsigned win = 0;
  bool fin = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int l = j * NL + sl, q = q0 + j * NL;
    const bool act = l < p.L;
    // min that keeps a NaN, like jnp
    const float e = act && q >= 0 && q < p.C
        ? (cc[j] > p.tmax ? p.tmax : cc[j]) : p.tmax;
    const bool in_win = act && l >= lo && l <= hi;
    win |= (unsigned)in_win << j;
    fin = fin || (in_win && e < INFINITY);
    cc[j] = e;
  }
  // all-invalid window -> 0 (mgm_costvolume.h:410-421), voted over the
  // row's segment
  const bool any = ((__ballot_sync(FULL_MASK, fin) >> seg0) & SEG) != 0;
#pragma unroll
  for (int j = 0; j < K; ++j)
    cc[j] = (win >> j) & 1u ? (any ? cc[j] : 0.f) : INFINITY;
  // update_cost2 halves each term (mgm_core.cc:83-84), only for the
  // unweighted SGM potential (pallas_fused.py:911)
  const bool halve = p.mgm == 2 && !FH && !W;
  // FH under per-pixel windows reads each message's input inside the
  // TARGET pixel's window only (pallas_fused.py:876-879, 902)
  const bool restrict_in = FH && G && p.fh_restrict;

  wait(live);  // the costs needed none of the neighbours' fronts
  const int nrec = p.plane_nrec[i];
  float sum[K];
#pragma unroll
  for (int j = 0; j < K; ++j) sum[j] = 0.f;
  for (int kr = 0; kr < nrec; ++kr) {
    const int m = p.plane_recs[i][kr];
    const int bd = p.rec_border[m];
    bool interior = live && col >= ((bd & 1) ? 1 : 0);
    if (bd & 2) interior = interior && col <= p.C - 2;
    if (bd & 4) interior = interior && rc >= 1;
    if (bd & 8) interior = interior && rc <= p.R - 2;
    // interior pixels read only neighbours inside the image, which
    // earlier fronts wrote; the others keep their cost (the select of
    // pallas_fused.py:932, never a multiply by a mask)
    float nv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) nv[j] = cc[j];
    if (NL == 32 ? interior : __any_sync(FULL_MASK, interior)) {
      // every dep's loads first, so they issue together, then the
      // messages in dep order
      float v[MGM_MAX_RANKS][K], mk[MGM_MAX_RANKS], p1w[MGM_MAX_RANKS],
          p2w[MGM_MAX_RANKS];
#pragma unroll
      for (int j = 0; j < MGM_MAX_RANKS; ++j)
        if (j < p.mgm)
          load_dep<W, K, NL>(p, hist, mins, m, j, slot_t, rc, mine_up,
                             mine_dn, pix, interior, win, restrict_in, nk,
                             sl, v[j], mk[j], p1w[j], p2w[j]);
      if constexpr (FH) {
        fh_up<K, NL>(v, p1w, p.mgm, p.L, sl);
#pragma unroll
        for (int j = 0; j < MGM_MAX_RANKS; ++j)
#pragma unroll
          for (int s2 = 0; s2 < K; ++s2)
            if (s2 * NL + sl >= p.L) v[j][s2] = INFINITY;
        fh_down<K, NL>(v, p1w, p.mgm, p.L, sl);
      }
      float acc[K];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = 0.f;
#pragma unroll
      for (int j = 0; j < MGM_MAX_RANKS; ++j)
        if (j < p.mgm)
          fold_message<FH, K, NL>(v[j], mk[j], p1w[j], p2w[j], j, halve, nk,
                                  sl, acc);
      if (NL == 32 || interior) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float a = acc[j];
          if (p.mgm > 1 && !halve) a = a / (float)p.mgm;
          nv[j] = cc[j] + a;
        }
      }
    }
    // the new front into the ring, and its minimum over all labels
    const size_t hrow = ((size_t)slot_t * p.Ml + m) * p.R + rc;
    float* const dst = hist + hrow * p.L;
    float mv = INFINITY;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (K > 6 && j >= nk) break;
      const int l = j * NL + sl;
      if (l < p.L) {
        if (live) dst[l] = nv[j];
        mv = nmin(mv, nv[j]);
      }
      sum[j] = kr ? sum[j] + nv[j] : nv[j];
    }
    mv = seg_min<NL>(mv);
    if (live && sl == 0) mins[hrow] = mv;
  }
  publish();  // the ring rows are written: the neighbours may go on
  if (!live) return;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (K > 6 && j >= nk) break;
    const int l = j * NL + sl;
    if (l >= p.L) continue;
    float o = nrec ? sum[j] : 0.f;
    if (p.plane_fold[i]) o = o + p.kappa * cc[j];
    // streaming stores: the volume must not push the ring out of L2
    __stcs(out + l, p.accumulate ? __ldcs(out + l) + o : o);
  }
}

// A local row's entry in the CTA's row table (dynamic shared memory):
// its image row (bits 0-19, R <= 16 * 58112) and where rows r -+ 1 lie:
// in this CTA, in another CTA of the cluster, or in another cluster;
// -1 for a local row past the image.
#define K1_ROW_MASK 0xfffff
#define K1_UP_MINE (1 << 20)
#define K1_UP_CTA (1 << 21)
#define K1_UP_GPU (1 << 22)
#define K1_DN_MINE (1 << 23)
#define K1_DN_CTA (1 << 24)
#define K1_DN_GPU (1 << 25)

// One scan direction: block (x, i, k) is CTA x of the ncl clusters of
// plane i, pair k (nc = cluster * ncl CTAs a unit; CTA x in cluster x /
// cluster).  The rows come in bands of plan.band rows dealt out to the
// unit's CTAs in turn (band b to CTA b mod nc), so that each CTA holds
// rows all down the image and the rows live on a front (a contiguous
// range in the sloped spaces) spread over every CTA; local row j of CTA
// x is image row ((j / band) * nc + x) * band + j % band.  A warp takes
// 32 / NL local rows at once, one a lane segment: rows w * 32/NL + h,
// then w + warps ..., on every front, in that order.  done[j] counts the
// fronts local row j has finished; a row whose neighbour lies in
// another cluster also publishes the count to the global array `gdone`
// tagged with the launch's epoch (epoch << 32 | count; earlier
// launches' entries are smaller).  A row runs the recursions of a front
// it has a pixel on, the u-th, once rows r -+ 1 have finished u fronts:
// they have then written every front it reads (lags >= 1) and read
// every front whose ring slot it overwrites (the ring keeps D + 1).
// (Letting a row run ahead of its neighbours would need every lag to a
// neighbour row to be 2 or more, and every fused schedule has a lag-1
// dep on a neighbour row.)  A row only ever waits for an earlier front,
// so no wait closes a cycle; with ncl > 1 the launch is refused unless
// every cluster of the grid fits the card at once.
template <int MODE, bool FH, bool W, bool G, int K, int NL>
__global__ void __launch_bounds__(k1_max_threads(K))
    fused_wavefront_cluster(const WaveParams p, const K1Plan plan,
                            unsigned long long* gdone,
                            unsigned long long epoch) {
  constexpr int RW = 32 / NL;  // rows a warp
  extern __shared__ int sm[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int x = blockIdx.x, nc = gridDim.x;  // the unit's CTA, CTAs
  const int i = blockIdx.y;
  const int k = G ? (int)blockIdx.z : 0;
  const int sl = threadIdx.x & (NL - 1);
  const int h = (threadIdx.x & 31) / NL;
  const int warps = blockDim.x >> 5;
  const int rows = plan.rows, band = plan.band;
  const int groups = (rows + RW - 1) / RW;
  int* const done = sm;
  int* const table = sm + rows;
  // where CTA y's rows live: this CTA, the cluster, another cluster
  auto where = [&](int y, int mine, int cta, int gpu) {
    return y == x ? mine
                  : (y / plan.cluster == x / plan.cluster ? cta : gpu);
  };
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    done[j] = 0;
    const int r = ((j / band) * nc + x) * band + j % band;
    int e = -1;
    if (r < p.R) {
      e = r;
      if (r > 0) e |= where((r - 1) / band % nc, K1_UP_MINE, K1_UP_CTA,
                            K1_UP_GPU);
      if (r + 1 < p.R)
        e |= where((r + 1) / band % nc, K1_DN_MINE, K1_DN_CTA, K1_DN_GPU);
    }
    table[j] = e;
  }
  cluster.sync();  // every counter is 0 before any is read
  const int T = p.fstep * (p.C - 1) + p.slope * (p.R - 1) + 1;
  // pair k's ring: (D + 1, Ml, R) rows after the earlier pairs'
  const size_t pair_rows = G ? (size_t)k * (p.D + 1) * p.Ml * p.R : 0;
  float* const hist = p.hist + pair_rows * p.L;
  float* const mins = p.mins + pair_rows;
  int t = p.reverse ? T - 1 : 0;
  int slot_t = t % (p.D + 1);  // front t's ring slot
  for (int u = 0; u < T; ++u) {
    for (int g = threadIdx.x >> 5; g < groups; g += warps) {
      const int j = g * RW + h;
      const int e = j < rows ? table[j] : -1;
      // local rows map to rising image rows: none further either
      if (!__any_sync(FULL_MASK, e >= 0)) break;
      const int r = e < 0 ? -1 : e & K1_ROW_MASK;
      // a neighbour in another CTA: counters through distributed shared
      // memory, in another cluster: through gdone
      const bool far = e >= 0 && (e & (K1_UP_CTA | K1_UP_GPU | K1_DN_CTA |
                                       K1_DN_GPU));
      row_front<MODE, FH, W, G, K, NL>(
          p, hist, mins, i, k, r, (e & K1_UP_MINE) != 0,
          (e & K1_DN_MINE) != 0, t, slot_t, sl,
          [&](bool live) {
            // every count is >= 0; gdone's may still hold an earlier
            // launch's
            if (!live || u == 0) return;
            if (e & K1_UP_MINE) {
              wait_cta(done + j - 1, u);
            } else if (e & K1_UP_CTA) {  // the last row of the band above
              const int b = (r - 1) / band;
              wait_cluster(cluster.map_shared_rank(
                               done + (b / nc) * band + band - 1,
                               b % nc % plan.cluster),
                           u);
            } else if (e & K1_UP_GPU) {
              wait_gpu(gdone + ((size_t)k * p.Mp + i) * p.R + r - 1,
                       epoch << 32 | (unsigned)u);
            }
            if (e & K1_DN_MINE) {
              wait_cta(done + j + 1, u);
            } else if (e & K1_DN_CTA) {  // the first row of the band below
              const int b = (r + 1) / band;
              wait_cluster(cluster.map_shared_rank(done + (b / nc) * band,
                                                   b % nc % plan.cluster),
                           u);
            } else if (e & K1_DN_GPU) {
              wait_gpu(gdone + ((size_t)k * p.Mp + i) * p.R + r + 1,
                       epoch << 32 | (unsigned)u);
            }
          },
          [&] {
            __syncwarp();  // every lane's ring writes precede the store
            if (sl == 0 && r >= 0) {
              if (!far) {
                publish_cta(done + j, u + 1);
              } else {
                publish_cluster(done + j, u + 1);
                if (e & (K1_UP_GPU | K1_DN_GPU))
                  publish_gpu(gdone + ((size_t)k * p.Mp + i) * p.R + r,
                              epoch << 32 | (unsigned)(u + 1));
              }
            }
          });
    }
    if (p.reverse) {
      --t;
      slot_t = slot_t == 0 ? p.D : slot_t - 1;
    } else {
      ++t;
      slot_t = slot_t == p.D ? 0 : slot_t + 1;
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour may read its counters
}

// Launches one scan direction with the plan's sizes, or, with `fit`,
// only stores there how many clusters of the plan's shape (cluster,
// CTA size, shared memory) the card holds at once.
template <int MODE, bool FH, bool W, bool G, int K, int NL>
int launch(const WaveParams& p, const K1Plan& plan, unsigned long long* gdone,
           unsigned long long epoch, cudaStream_t s, int* fit) {
  void (*kern)(const WaveParams, const K1Plan, unsigned long long*,
               unsigned long long) =
      fused_wavefront_cluster<MODE, FH, W, G, K, NL>;
  cudaError_t err = cudaSuccess;
  if (plan.cluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && plan.smem > 0)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cluster * plan.ncl, p.Mp, p.npair);
  cfg.blockDim = dim3(k1_warps(plan.rows, K, NL) * 32, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (fit != nullptr) {
    *fit = active;
    return 0;
  }
  // clusters of one unit wait on each other: all of the grid's must be
  // on the card at once
  if (active < 1 ||
      (plan.ncl > 1 && (long long)plan.ncl * p.Mp * p.npair > active))
    return MGM_ERR_NO_CLUSTER;
  err = cudaLaunchKernelEx(&cfg, kern, p, plan, gdone, epoch);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

typedef int (*Launch)(const WaveParams&, const K1Plan&, unsigned long long*,
                      unsigned long long, cudaStream_t, int*);

template <int MODE, bool FH, bool W, bool G>
Launch pick_k(int L) {
  switch (k1_lanes(L)) {
    case 3: return launch<MODE, FH, W, G, 3, 16>;
    case 2: return launch<MODE, FH, W, G, 2, 32>;
    case 5: return launch<MODE, FH, W, G, 5, 32>;
    case 6: return launch<MODE, FH, W, G, 6, 32>;
    case 32: return launch<MODE, FH, W, G, 32, 32>;
    default: return nullptr;
  }
}

template <int MODE, bool FH>
Launch pick_wg(bool w, bool g, int L) {
  if (w)
    return g ? pick_k<MODE, FH, true, true>(L)
             : pick_k<MODE, FH, true, false>(L);
  return g ? pick_k<MODE, FH, false, true>(L)
           : pick_k<MODE, FH, false, false>(L);
}

// The instance of cost family MODE for the launch's potential, weights,
// windows or pairs and labels (nullptr beyond MGM_MAX_LABELS); each
// family's instances compile in a file of their own
// (fused_wavefront_<family>.cu), so the five build in parallel.
template <int MODE>
Launch pick(bool fh, bool w, bool g, int L) {
  return fh ? pick_wg<MODE, true>(w, g, L) : pick_wg<MODE, false>(w, g, L);
}
