// K5: the dense MGM recursion over a canonical pass group, read from and
// written to image layout, in one launch; and K5 on a band (template flag
// BAND), one launch a block of fronts on one rank's band of rows.
//
// Replaces the TPU kernel mgm_tpu/ops/pallas_wavefront.py:_kernel (its
// front update _front_update, :177; launched by wavefront_scan, :328),
// and absorbs the TPU's layout kernels _skew_kernel (skew_p, :79) and
// _unskew_kernel (unskew_p, :107).  It computes the same thing: for
// every front t of the pass's canonical scan (front t holds canonical
// pixel (r, t - slope*r) of each row r), each pixel's 1-4
// coupled messages from the causal offsets W / N / NW / NE / WWN, SGM
// or truncated-linear (FH, by log2(L) min-plus doubling steps), with
// optional per-offset weights and the FH label-window restriction, the
// update_cost2 halving quirk, the 1-pixel border rule (two columns on
// the left for knight passes), and the per-pixel minimum of the new
// front that later fronts read.
//
// What is not carried over is the TPU's blocking: the G-front VMEM
// blocks, the D-deep history scratch, and the skewed volume that made
// each front one block to copy in (with the copies into canonical
// orientation before it and back after it).  Here the skew and the
// orientation are address arithmetic: plane m = b*N + n (pass b of image
// n) reads its canonical pixel (r, c) at image pixel n*H*W + origin[b] +
// r*dr[b] + c*dc[b] of the costs (N, H, W, L), weights (N, H, W, 8) and
// windows (N, H, W), and writes it at the same pixel of pass b's output
// (out (B, N, H, W, L)): every pixel, a border pixel with its cost.  A
// row's next column lies dc*L floats on.  The history is that output
// itself (plus the (M, R, C) minima): front t reads fronts t - lag,
// which are final by then.
//
// Design.  Pixel (r, c) reads its own row's column c - 1 (W) and row
// r - 1's columns c + slope - lag (N, NW, NE, WWN; every lag >= 1), so a
// row needs only the row above to be far enough along, and rows may lag
// one another freely: the kernel steps every front of the group itself,
// a warp walking its row's C columns in order, with no barrier a front.
// A warp holds a row (labels across the lanes, K to a lane in registers:
// label j*NL + sub-lane in slot j), or, for L <= 48, the same row of two
// planes on 16-lane segments in lockstep (rows of one plane never share
// a warp: the lower would wait on the upper).  The W message comes from
// the registers of the previous column; the messages are warp_rows.cuh's
// shuffles (the SGM label neighbours, FH's doubling in _fh_msg's order of
// steps), the minimum its segment minimum.  The rows come in bands of
// plan.warps rows of one plane group, band beta (rows (beta / MP) *
// warps ..., plane group beta % MP) to CTA beta mod ctas, row j of the
// band to warp j, so the rows live on a front spread over every CTA.
//
// A row's step is latency-bound, so little on it waits for device
// memory or for a fence: a warp hands each finished column (values and
// minimum) to the next warp of its band through a ring of its last D
// columns in shared memory, each word a value with its column's count
// in one 64-bit access, so the reader waits only until the words it
// reads carry the count it wants; the writer reuses a slot once the
// reader's count (shared memory) is past it.  The row's own costs are
// loaded a column ahead into registers and prefetched into L2 four
// ahead; its weights and windows NL columns at a time, a pixel a lane,
// each column taking its own by a shuffle (in a column-major pass a
// pixel's next column lies W pixels on: one strided load a column cost
// the weighted SGM instance 14-16 % at mgm_o on the H100, the batch
// 7 %).  Only a band's first row reads the row above from the output:
// that row's warp, in another CTA, publishes its count of finished
// columns every K5_PUB columns to a global array,
// one slot a CTA, tagged with the launch's epoch (release / acquire at
// GPU scope, the rows read from L2, ld.global.cg, the next column's
// loaded ahead where the count covers it).  On the H100 a column still
// takes about 2,000-2,600 cycles (clock64 phase counts, PERF.md §6):
// some 1,400 for the messages, the minimum and the stores, about 500
// waiting for the row's own costs, the rest waiting for the row above;
// per-column counts through shared memory with fences, the bridge of a
// band's count through a helper warp and costs loaded two columns
// ahead each moved it by no more than the noise.  A warp only ever
// waits on a row of an earlier band or the warp above in its band, or
// (the ring) on the warp below, which never waits on a column the
// writer has not written, so no wait closes a cycle;
// ops/wavefront.k5_plan sizes the launch so that every CTA is resident
// at once (the occupancy query mgm_k5_fit), and a launch the card cannot
// hold is refused.
//
// Bound: the chain of dependent row-fronts, about R * slope + C of them
// (a row starts slope columns behind the row above), each the latency of
// one warp's messages and minimum; the bytes are one read of each pass's
// costs and one write of its output and of the minima (no skewed volume
// and no fill exist).
//
// Instances: FH, weights (W), and the labels a lane K with the lanes a
// row NL (labels_a_lane: (16, 3), (32, 2), (32, 5), (32, 6), (32, 32))
// are template flags, 20 instances; the rest is read at run time.
//
// Border: each pass's first real canonical row, first real column and
// real column count (row0, col0, c1: mgm_tpu's masks shifted for mesh
// padding rows, ops/aggregate._pad_geometry; 0, 0, C without them) bound
// the pixels that aggregate.
//
// K5 on a band (BAND; csrc/wavefront_band.cu) replaces the recursion that
// mgm_tpu/parallel/halo.py:27-138 (_halo_scan) runs in XLA on a rank's
// band of canonical rows: a lax.scan over every front with a ppermute of
// the band's last row a front.  Here a launch runs the G fronts t0 ..
// t0 + G - 1 of the band's rows (local row r is global canonical row r0 +
// r; front t holds its column t - slope * (r0 + r)), so a row walks the
// columns [cs, ce) of the block: the same warps, bands of rows and rings,
// with the recursion's state (each row's earlier columns and minima) in
// the output from the earlier blocks' launches, read where a row starts
// its block (the W message's previous column) and where the row above's
// columns were finished before it (in place of the ring or the counts).
// The band's first row reads the row above it from the halo ring (the
// upstream rank's last row, values and minima, its front s at entry s
// mod 2G: complete before the launch, so nothing waits on it), and the
// band's last row writes its columns of the block into the ship track,
// which the host hands to the downstream rank.  The fronts of a block
// run in one launch and the blocks of a band in launches on one stream,
// so a band costs its fronts' chain as K5 does plus a launch a block;
// the bytes are K5's plus the tracks (G fronts of M rows of L + 1 floats
// a block, each way).
//
// Numerics follow the plain PyTorch version in ops/wavefront.py
// operation for operation (built with --fmad=false, no fast math).
// Minima keep NaN as torch.minimum does: border messages may be
// inf - inf, and the interior select never reads them.
#pragma once

#include "warp_rows.cuh"

// the plan's CTAs do not all fit the card at once
#define MGM_ERR_NOT_RESIDENT (-1)
// the columns between a band's last row's global counts (4 and 8 were
// 10 % and 25 % slower at the NCC group on the H100: the next band's
// first row waits on them)
#define K5_PUB 2

// The CTA size limit of the instance with K labels a lane: 128 registers
// a thread up to 6 labels a lane, 255 at 32.
__host__ __device__ constexpr int k5_max_threads(int K) {
  return K <= 6 ? 512 : 256;
}

// The columns a warp's ring holds (a power of 2, at least 4: a row reads
// the row above from two columns back to one ahead).
__host__ __device__ constexpr int k5_ring(int K) { return K <= 6 ? 8 : 4; }

// A ring word: a value and the count of the column it belongs to, read
// and written whole (64-bit accesses to shared memory are single-copy
// atomic), so a reader that finds its count needs no other ordering.
__device__ __forceinline__ unsigned long long ring_load(
    const unsigned long long* a) {
  return *(const volatile unsigned long long*)a;
}

__device__ __forceinline__ void ring_store(unsigned long long* a, int tag,
                                           float v) {
  *(volatile unsigned long long*)a =
      (unsigned long long)(unsigned)tag << 32 | __float_as_uint(v);
}

__device__ __forceinline__ int clamp_cols(long long x, int C) {
  return x < 0 ? 0 : x > C ? C : (int)x;
}

template <bool BAND, bool FH, bool W, int K, int NL>
__global__ void __launch_bounds__(k5_max_threads(K))
    wavefront_rows(const ScanParams p, const K5Plan plan,
                   unsigned long long* gdone, unsigned long long epoch) {
  constexpr int RW = 32 / NL;     // planes a warp
  constexpr int D = k5_ring(K);
  constexpr bool PRE = K <= 6;    // the next column's rows above ahead
  const int lane = threadIdx.x & 31, wj = threadIdx.x >> 5;
  const int sl = lane & (NL - 1), h = lane / NL;
  const int WC = blockDim.x >> 5;
  const int C = p.C, L = p.L, mgm = p.mgm;
  // shared memory: each warp's ring of its row's last D columns (values
  // and minimum of each of its planes), then each warp's count of
  // finished columns
  const int SL = RW * (L + 1);  // words a ring slot
  extern __shared__ unsigned long long ring[];
  int* const done = (int*)(ring + (size_t)WC * D * SL);
  for (int k = threadIdx.x; k < WC * D * SL; k += blockDim.x) ring[k] = 0;
  for (int k = threadIdx.x; k < WC; k += blockDim.x) done[k] = 0;
  __syncthreads();
  const int nk = (L + NL - 1) / NL;  // slots holding a label
  const int MP = (p.M + RW - 1) / RW;
  const long long nbands = (long long)MP * ((p.R + WC - 1) / WC);
  const unsigned long long tag = epoch << 32;
  // coupled dir j: its row in the row above (column offset dcol) or its
  // own row's previous column; `ahead`: the furthest column above read
  // (the kernel's parameters are copied to registers before lambdas
  // capture them: a reference to a parameter would move it to the stack)
  bool up[MGM_MAX_RANKS];
  int dcol[MGM_MAX_RANKS];
  int ahead = -C;
  bool any_up = false;
#pragma unroll
  for (int j = 0; j < MGM_MAX_RANKS; ++j) {
    up[j] = false;
    dcol[j] = 0;
    if (j < mgm) {
      const int k = p.dir_rank[j];
      up[j] = p.off_shift[k] != 0;
      dcol[j] = p.slope - p.off_lag[k];
      if (up[j]) {
        any_up = true;
        ahead = dcol[j] > ahead ? dcol[j] : ahead;
      }
    }
  }
  // update_cost2 halves each term (mgm_core.cc:83-84), only for the
  // unweighted SGM potential
  const bool halve = mgm == 2 && !FH && !W;
  const bool restrict_in = FH && p.fh_restrict;
  const float p1 = p.p1, p2 = p.p2;
  const float* const wts = p.w8;
  const int* const lo_c = p.lo;
  const int* const hi_c = p.hi;
  const int R = p.R;
  const long long HW = (long long)p.H * p.W;
  // the 1-pixel border; knight passes reach 2 columns left and have no
  // +x offset
  const int bl = p.knight ? 2 : 1, br = p.knight ? 1 : 2;
  // BAND: the halo ring and the ship track, 2G and G fronts of M rows
  const float* const halo_v = p.halo;
  const float* const halo_m = p.halo_m;
  float* const ship_v = p.ship;
  float* const ship_m = p.ship_m;
  const int slope = p.slope, M = p.M, G = BAND ? p.G : 0;
  const int t0 = BAND ? p.t0 : 0;
  // the columns of the row above that column i reads: 0 .. need(i) - 1
  auto need = [&](int i) { return i + 1 + ahead < C ? i + 1 + ahead : C; };
  // this warp's ring, and the ring of the warp above it
  unsigned long long* const own_ring = ring + (size_t)wj * D * SL + h * (L + 1);
  const unsigned long long* const up_ring =
      wj ? own_ring - (size_t)D * SL : nullptr;

  int base = 0;  // the counts' offset of this band: its turn * C
  for (long long beta = blockIdx.x; beta < nbands;
       beta += gridDim.x, base += C) {
    const int b = (int)(beta / MP), g = (int)(beta % MP);
    const int r = b * WC + wj;
    if (r >= R) break;  // this CTA's later bands lie no higher
    int m = g * RW + h;
    // a segment past the last plane computes plane M - 1's row and
    // stores nothing to the output
    const bool mine = m < p.M;
    if (!mine) m = p.M - 1;
    // plane m is pass ps of image img: its canonical pixel (r, i) is
    // image pixel pix0 + i * dc (ops/aggregate.pass_map), its costs at
    // that pixel of cc, its output at that pixel of pass ps's volume
    const int ps = m / p.N, img = m - ps * p.N;
    const int dc = p.dc[ps];
    // the row's global canonical row, and the columns that aggregate
    const int rg = BAND ? p.r0 + r : r;
    const bool row_in = rg >= p.row0[ps] + 1;
    const int clo = p.col0[ps] + bl, chi = p.col0[ps] + p.c1[ps] - br;
    auto interior = [&](int i) { return row_in && i >= clo && i <= chi; };
    // the columns this launch steps, [cs, ce), and the row above's that
    // earlier launches finished (0 .. up_cs - 1)
    int cs = 0, ce = C, up_cs = 0;
    if (BAND) {
      const long long a = (long long)t0 - (long long)slope * rg;
      cs = clamp_cols(a, C);
      ce = clamp_cols(a + G, C);
      up_cs = clamp_cols(a + slope, C);
    }
    // the band's first row reads the row above from the halo ring
    const bool halo_row = BAND && r == 0;
    const long long pix0 = img * HW + p.origin[ps] + (long long)r * p.dr[ps];
    const long long step = (long long)dc * L;  // floats to the next column
    const float* const crow = p.cc + pix0 * L;
    float* const vrow = p.out + ((long long)ps * p.N * HW + pix0) * L;
    const size_t rc = (size_t)m * R + r;
    float* const mrow = p.mins + rc * C;
    const float* const vup = r ? vrow - (long long)p.dr[ps] * L : nullptr;
    const float* const mup = r ? p.mins + (rc - 1) * C : nullptr;
    // each coupled dir's weight channel in w8, 3 bits a dir (one register)
    unsigned wc = 0;
#pragma unroll
    for (int j = 0; j < MGM_MAX_RANKS; ++j)
      if (W && j < mgm) wc |= (unsigned)p.wch[ps][p.dir_rank[j]] << (3 * j);
    // the row below is the next warp's: it reads this row from the ring
    const bool feed = wj + 1 < WC && r + 1 < R;
    int below = 0;  // the next warp's count, as last read

    // the row above in another CTA (this warp the first of its band):
    // the last row of band beta - MP, CTA (beta - MP) mod ctas, its turn
    // (beta - MP) / ctas, its count in gdone
    const bool far = wj == 0;
    const long long pb = beta - MP;
    const unsigned long long* const gsrc =
        far && r > 0 ? gdone + pb % gridDim.x : nullptr;
    const long long pbase = far && r > 0 ? (pb / gridDim.x) * C : 0;
    // its finished columns, as last read (the halo ring: all of them)
    int seen = halo_row ? C : up_cs;
    // re-read the count until it covers `want` columns
    auto look = [&](int want) {
      unsigned ns = 32;
      for (;;) {
        const unsigned long long v = acquire_gpu(gsrc);
        const long long d = v >= tag ? (long long)(v - tag) - pbase : 0;
        if (d > seen) seen = d > C ? C : (int)d;
        if (seen >= want) return;
        __nanosleep(ns);
        if (ns < 256) ns *= 2;
      }
    };

    // the inputs of a column that no other row writes: the row's costs
    // (a column ahead), each dep's weight, the label window
    float cc[K], ccn[K], dw[MGM_MAX_RANKS];
    int lo = 0, hi = 0;
    auto load_in = [&](int i) {
      const float* const src = crow + i * step;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int l = s * NL + sl;
        ccn[s] = INFINITY;
        if ((K <= 6 || s < nk) && l < L) ccn[s] = src[l];
      }
    };
    // the weights and the window come NL columns at a time, one pixel a
    // lane: lane sl of the segment loads column c0 + sl's (and prefetches
    // the next NL columns' into L2), and column i takes its own from the
    // segment's lane i mod NL by a shuffle.  A pixel's weights and window
    // lie W pixels apart from the next column's in a column-major pass:
    // one load a segment in place of a strided load a column.
    float wb[MGM_MAX_RANKS];
    int lob = 0, hib = 0;
#pragma unroll
    for (int j = 0; j < MGM_MAX_RANKS; ++j) wb[j] = 1.f;
    auto load_side = [&](int c0) {
      const int c = c0 + sl;
      const long long px = pix0 + (long long)c * dc;
      if (c < C) {
        if constexpr (W) {
#pragma unroll
          for (int j = 0; j < MGM_MAX_RANKS; ++j)
            if (j < mgm) wb[j] = wts[px * 8 + ((wc >> (3 * j)) & 7u)];
        }
        if (restrict_in) {
          lob = lo_c[px];
          hib = hi_c[px];
        }
      }
      if (c + NL < C) {
        const long long pn = px + (long long)NL * dc;
        if (W) asm volatile("prefetch.global.L2 [%0];" ::"l"(wts + pn * 8));
        if (restrict_in) {
          asm volatile("prefetch.global.L2 [%0];" ::"l"(lo_c + pn));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(hi_c + pn));
        }
      }
    };
    // the rows above that column i reads (+inf beyond the image's
    // columns, as the TPU's skew fill) and their minima: from the warp
    // above's ring, waiting until its words carry their column's count,
    // or from another CTA's row in the output
    float v[MGM_MAX_RANKS][K], mk[MGM_MAX_RANKS];
    float vn[MGM_MAX_RANKS][K], mkn[MGM_MAX_RANKS];
    auto load_up = [&](int i, float (&dst)[MGM_MAX_RANKS][K],
                       float (&dm)[MGM_MAX_RANKS]) {
#pragma unroll
      for (int j = 0; j < MGM_MAX_RANKS; ++j) {
        if (j >= mgm || !up[j]) continue;
        const int col = i + dcol[j];
        dm[j] = INFINITY;
#pragma unroll
        for (int s = 0; s < K; ++s) dst[j][s] = INFINITY;
        if (col < 0 || col >= C) continue;
        if (halo_row) {
          // the upstream rank's row at front col + slope * (rg - 1)
          const size_t e =
              (size_t)((col + slope * (rg - 1)) % (2 * G)) * M + m;
          const float* const src = halo_v + e * L;
          dm[j] = halo_m[e];
#pragma unroll
          for (int s = 0; s < K; ++s) {
            const int l = s * NL + sl;
            if ((K <= 6 || s < nk) && l < L) dst[j][s] = src[l];
          }
        } else if (!far && col >= up_cs) {
          const unsigned long long* const src =
              up_ring + (size_t)((base + col) & (D - 1)) * SL;
          const unsigned want = base + col + 1;
          for (;;) {
            bool ok = true;
#pragma unroll
            for (int s = 0; s < K; ++s) {
              const int l = s * NL + sl;
              if ((K <= 6 || s < nk) && l < L) {
                const unsigned long long w = ring_load(src + l);
                dst[j][s] = __uint_as_float((unsigned)w);
                ok = ok && (unsigned)(w >> 32) == want;
              }
            }
            const unsigned long long w = ring_load(src + L);
            dm[j] = __uint_as_float((unsigned)w);
            ok = ok && (unsigned)(w >> 32) == want;
            if (__all_sync(FULL_MASK, ok)) break;
            __nanosleep(32);
          }
        } else {
          const float* const src = vup + col * step;
          dm[j] = __ldcg(mup + col);
#pragma unroll
          for (int s = 0; s < K; ++s) {
            const int l = s * NL + sl;
            if ((K <= 6 || s < nk) && l < L) dst[j][s] = __ldcg(src + l);
          }
        }
      }
    };

    if (cs < ce) load_in(cs);
    float prev[K];  // the previous column's new values, and their minimum
#pragma unroll
    for (int s = 0; s < K; ++s) prev[s] = INFINITY;
    float pmin = INFINITY;
    if (BAND && cs > 0 && cs < ce) {
      // the block starts past the row's first column: the previous column
      // from the output of an earlier launch
      const float* const src = vrow + (long long)(cs - 1) * step;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int l = s * NL + sl;
        if ((K <= 6 || s < nk) && l < L) prev[s] = __ldcg(src + l);
      }
      pmin = __ldcg(mrow + cs - 1);
    }
    // columns before cs need no ring slot of the row above (BAND)
    if (BAND && lane == 0) *(volatile int*)(done + wj) = base + cs;
    bool have = false;  // vn holds this column's rows above
    int pc = 0;         // columns since the last global count
    // the band's last row ships its block's columns downstream
    const bool ship_row = BAND && r + 1 == R && ship_v != nullptr && mine;
    for (int i = cs; i < ce; ++i) {
      // this column's costs, loaded a column ahead, then the next's
#pragma unroll
      for (int s = 0; s < K; ++s) cc[s] = ccn[s];
      if (i + 1 < C) load_in(i + 1);
      if (i + 4 < C) {  // and into L2 three columns further
        const float* const q = crow + (i + 4) * step;
        for (int o = lane * 32; o < L; o += 32 * 32)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(q + o));
      }
      // this column's weights and window from the segment's lanes
      if ((W || restrict_in) && ((i & (NL - 1)) == 0 || i == cs))
        load_side(i & ~(NL - 1));
#pragma unroll
      for (int j = 0; j < MGM_MAX_RANKS; ++j)
        if (W && j < mgm) dw[j] = __shfl_sync(FULL_MASK, wb[j], i, NL);
      if (restrict_in) {
        lo = __shfl_sync(FULL_MASK, lob, i, NL);
        hi = __shfl_sync(FULL_MASK, hib, i, NL);
      }
      float nv[K];
#pragma unroll
      for (int s = 0; s < K; ++s) nv[s] = cc[s];
      // border pixels keep their cost (the select of the plain version,
      // never a multiply by a mask): nothing to read above
      if (interior(i)) {
        if (have) {
#pragma unroll
          for (int j = 0; j < MGM_MAX_RANKS; ++j) {
            if (j >= mgm || !up[j]) continue;
            mk[j] = mkn[j];
#pragma unroll
            for (int s = 0; s < K; ++s) v[j][s] = vn[j][s];
          }
        } else if (any_up) {
          if (far && !halo_row) look(need(i));
          load_up(i, v, mk);
        }
        have = false;
        if (PRE && far && any_up && i + 1 < ce && interior(i + 1) &&
            seen >= need(i + 1)) {
          // the next column's rows above in another CTA, where its count
          // covers them already
          load_up(i + 1, vn, mkn);
          have = true;
        }
        // labels in the FH input: the target pixel's window under
        // fh_restrict, else all L
        unsigned win = 0;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const int l = s * NL + sl;
          const bool in = l < L && (!restrict_in || (l >= lo && l <= hi));
          win |= (unsigned)in << s;
        }
        float p1w[MGM_MAX_RANKS], p2w[MGM_MAX_RANKS];
#pragma unroll
        for (int j = 0; j < MGM_MAX_RANKS; ++j) {
          p1w[j] = p1;
          p2w[j] = p2;
          if (j >= mgm) continue;
          if constexpr (W) {
            p1w[j] = dw[j] * p1;
            p2w[j] = dw[j] * p2;
          }
          if (!up[j]) {  // W: the row's own previous column
            mk[j] = pmin;
#pragma unroll
            for (int s = 0; s < K; ++s) v[j][s] = prev[s];
          }
#pragma unroll
          for (int s = 0; s < K; ++s)
            if (!((win >> s) & 1u)) v[j][s] = INFINITY;
        }
        if constexpr (FH) {
          fh_up<K, NL>(v, p1w, mgm, L, sl);
#pragma unroll
          for (int j = 0; j < MGM_MAX_RANKS; ++j)
#pragma unroll
            for (int s = 0; s < K; ++s)
              if (s * NL + sl >= L) v[j][s] = INFINITY;
          fh_down<K, NL>(v, p1w, mgm, L, sl);
        }
        float acc[K];
#pragma unroll
        for (int s = 0; s < K; ++s) acc[s] = 0.f;
#pragma unroll
        for (int j = 0; j < MGM_MAX_RANKS; ++j)
          if (j < mgm)
            fold_message<FH, K, NL>(v[j], mk[j], p1w[j], p2w[j], j, halve,
                                    nk, sl, acc);
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (K > 6 && s >= nk) break;
          float a = acc[s];
          if (mgm > 1 && !halve) a = a / (float)mgm;
          nv[s] = cc[s] + a;
        }
      } else {
        have = false;
      }
      if (mine) {  // every pixel of the output, a border pixel its cost
        float* const dst = vrow + i * step;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (K > 6 && s >= nk) break;
          const int l = s * NL + sl;
          if (l < L) dst[l] = nv[s];
        }
      }
      float mv = INFINITY;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (K > 6 && s >= nk) break;
        if (s * NL + sl < L) mv = nmin(mv, nv[s]);
      }
      mv = seg_min<NL>(mv);
      if (mine && sl == 0) mrow[i] = mv;
      if (ship_row) {
        const size_t e = (size_t)(i + slope * rg - t0) * M + m;
        float* const dst = ship_v + e * L;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (K > 6 && s >= nk) break;
          const int l = s * NL + sl;
          if (l < L) dst[l] = nv[s];
        }
        if (sl == 0) ship_m[e] = mv;
      }
      if (feed) {
        // the ring slot of column i held column i - D: wait until the
        // next warp is past it (it reads two columns back)
        const int free_at = base + i - D + 3;
        while (below < free_at) {
          below = *(volatile int*)(done + wj + 1);
          if (below < free_at) __nanosleep(32);
        }
        unsigned long long* const slot =
            own_ring + (size_t)((base + i) & (D - 1)) * SL;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const int l = s * NL + sl;
          if ((K <= 6 || s < nk) && l < L) ring_store(slot + l, base + i + 1,
                                                      nv[s]);
        }
        if (sl == 0) ring_store(slot + L, base + i + 1, mv);
      }
      if (lane == 0) *(volatile int*)(done + wj) = base + i + 1;
      if (wj + 1 == WC && r + 1 < R && (++pc == K5_PUB || i + 1 == ce)) {
        // the next band's first row, in another CTA, reads this one from
        // the output
        pc = 0;
        __syncwarp();  // every lane's writes precede the count
        if (lane == 0)
          publish_gpu(gdone + blockIdx.x, tag | (unsigned)(base + i + 1));
      }
#pragma unroll
      for (int s = 0; s < K; ++s) prev[s] = nv[s];
      pmin = mv;
    }
    // this block's ring reads are done: the warp above may reuse its slots
    if (BAND && lane == 0) *(volatile int*)(done + wj) = base + C;
  }
}

typedef void (*K5Kernel)(const ScanParams, const K5Plan, unsigned long long*,
                         unsigned long long);

template <bool BAND, bool FH, bool W>
static K5Kernel pick_k(int L) {
  switch (labels_a_lane(L)) {
    case 3: return wavefront_rows<BAND, FH, W, 3, 16>;
    case 2: return wavefront_rows<BAND, FH, W, 2, 32>;
    case 5: return wavefront_rows<BAND, FH, W, 5, 32>;
    case 6: return wavefront_rows<BAND, FH, W, 6, 32>;
    case 32: return wavefront_rows<BAND, FH, W, 32, 32>;
    default: return nullptr;
  }
}

// The instance for the launch's parameters, after checking them against
// the kernel's limits (nullptr: outside them).
template <bool BAND>
static K5Kernel k5_instance(const ScanParams& p) {
  const long long HW = (long long)p.H * p.W;
  if (p.L < 1 || p.L > MGM_MAX_LABELS || p.mgm < 1 ||
      p.mgm > MGM_MAX_RANKS || p.noffs < 1 || p.noffs > MGM_MAX_OFFS ||
      p.slope < 1 || p.B < 1 || p.B > MGM_MAX_PASSES || p.N < 1 ||
      p.M != p.B * p.N || p.R < 1 || p.C < 1 ||
      (long long)p.R * p.C != HW || p.cc == nullptr || p.out == nullptr ||
      p.mins == nullptr || (p.use_weights && p.w8 == nullptr) ||
      (p.use_fh && p.fh_restrict && (p.lo == nullptr || p.hi == nullptr)))
    return nullptr;
  // a band: blocks of at least the deepest lag, a halo ring above every
  // band but the first, a block's fronts inside the band's
  if (BAND && (p.G < 4 || p.r0 < 0 || (p.r0 > 0) != (p.halo != nullptr) ||
               (p.halo != nullptr && p.halo_m == nullptr) ||
               (p.ship != nullptr && p.ship_m == nullptr) || p.t0 < 0 ||
               p.t0 >= p.C + (long long)p.slope * (p.r0 + p.R - 1)))
    return nullptr;
  // each pass's map: every corner of its canonical pixels in the image
  // (the map is linear, so every pixel is), weight channels in w8
  for (int b = 0; b < p.B; ++b) {
    for (int cr = 0; cr < 4; ++cr) {
      const long long x = p.origin[b] +
                          (long long)(cr & 1) * (p.R - 1) * p.dr[b] +
                          (long long)(cr >> 1) * (p.C - 1) * p.dc[b];
      if (x < 0 || x >= HW) return nullptr;
    }
    for (int k = 0; k < p.noffs; ++k)
      if (p.use_weights && (p.wch[b][k] < 0 || p.wch[b][k] > 7))
        return nullptr;
    if (p.row0[b] < 0 || p.col0[b] < 0 || p.c1[b] < 1 ||
        p.col0[b] + p.c1[b] > p.C)
      return nullptr;
  }
  for (int j = 0; j < p.mgm; ++j) {
    const int k = p.dir_rank[j];
    // the W message comes from the previous column's registers
    if (k < 0 || k >= p.noffs || p.off_lag[k] < 1 ||
        (p.off_shift[k] != 0 && p.off_shift[k] != 1) ||
        (!p.off_shift[k] && p.off_lag[k] != 1))
      return nullptr;
  }
  const bool fh = p.use_fh != 0, w = p.use_weights != 0;
  if (fh)
    return w ? pick_k<BAND, true, true>(p.L) : pick_k<BAND, true, false>(p.L);
  return w ? pick_k<BAND, false, true>(p.L) : pick_k<BAND, false, false>(p.L);
}

// CTAs of the plan's shape (warps, shared memory) that the card holds at
// once, or -1 for a plan outside the instance's limits or a failed query.
static int k5_held(K5Kernel kern, const ScanParams& p, const K5Plan& plan) {
  const int K = labels_a_lane(p.L);
  // the rings and the counts (ops/wavefront.k5_plan computes the same)
  const long long smem =
      (long long)plan.warps * (k5_ring(K) * (K == 3 ? 2 : 1) * (p.L + 1) * 8 + 4);
  if (plan.warps < 1 || plan.warps * 32 > k5_max_threads(K) ||
      plan.smem != smem || plan.smem > 232448)
    return -1;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           plan.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, plan.warps * 32, plan.smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm * sms;
}


// CTAs of the plan's shape that the card holds at once for the launch's
// instance (ops/wavefront.k5_plan sizes the launch by it), or -1 for
// parameters or a plan outside the kernel's limits.
template <bool BAND>
static int k5_fit(const ScanParams* params, const K5Plan* kplan) {
  const K5Kernel kern = k5_instance<BAND>(*params);
  return kern == nullptr ? -1 : k5_held(kern, *params, *kplan);
}

// One launch on `stream` with the plan's sizes: returns the CUDA error of
// the launch (0 when it was accepted), cudaErrorInvalidValue for
// parameters or a plan outside the kernel's limits, or
// MGM_ERR_NOT_RESIDENT when the card cannot hold all of the plan's CTAs
// at once (their rows wait on one another).  gdone: plan.ctas counts,
// tagged with `epoch`, which must exceed every earlier launch's on that
// buffer (below 2^32).
template <bool BAND>
static int k5_launch(const ScanParams* params, const K5Plan* kplan,
                     unsigned long long* gdone, unsigned long long epoch,
                     void* stream) {
  const ScanParams p = *params;
  const K5Plan plan = *kplan;
  const K5Kernel kern = k5_instance<BAND>(p);
  if (kern == nullptr || gdone == nullptr || epoch >= (1ull << 32) ||
      plan.ctas < 1 || plan.warps < 1)
    return (int)cudaErrorInvalidValue;
  // a CTA's counts stay below 2^31: its bands times C
  const int rw = labels_a_lane(p.L) == 3 ? 2 : 1;  // planes a warp
  const long long bands = (long long)((p.M + rw - 1) / rw) *
                          ((p.R + plan.warps - 1) / plan.warps);
  if (((bands + plan.ctas - 1) / plan.ctas) * p.C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int held = k5_held(kern, p, plan);
  if (held < 0) return (int)cudaErrorInvalidValue;
  if (plan.ctas > held) return MGM_ERR_NOT_RESIDENT;
  kern<<<plan.ctas, plan.warps * 32, plan.smem, (cudaStream_t)stream>>>(
      p, plan, gdone, epoch);
  return (int)cudaGetLastError();
}
