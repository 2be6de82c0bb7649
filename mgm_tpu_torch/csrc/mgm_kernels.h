// Parameter blocks of the port's hand-written kernels (plain C layout:
// mgm_tpu_torch/ops/cuda_fused.py mirrors each struct with ctypes and
// checks its size against the *_params_size() entry points).
#pragma once

#define MGM_MAX_PLANES 8
#define MGM_MAX_RECS 32
#define MGM_MAX_COMBOS 16
#define MGM_MAX_RANKS 4
#define MGM_MAX_SIDES 16
#define MGM_MAX_LABELS 1024

// One scan direction of the fused cost + MGM recursion (K1).
struct WaveParams {
  const void* left;    // (N, R, C, nch) left image of each side: float32,
                       // int32 census words, or BT's [I, Imin, Imax]
  const void* right;   // (N, R, C, nch) right image of each side
  const float* w8;     // (N, R, C, 8) edge weights of each side, or 0
  // (N, R, C) per-pixel label windows of each side (-m/-M), or 0: the
  // plane's constant window then applies
  const int* lo_px;
  const int* hi_px;
  float* out;          // (Mp / nsides * N, R, C, L) sums, image layout
  float* hist;         // (npair, D + 1, Ml, R, L) ring of recursion fronts
  float* mins;         // (npair, D + 1, Ml, R) their minima over labels
  int R, C, L, nch;
  int Mp, Ml, D;       // a pair's planes and recursions, deepest lag
  // image pairs (the grid's third axis) and sides a pair: side s of
  // pair k is image n = k * nsides + s of left, right, w8 and the
  // windows (N = npair * nsides), and the planes come space-major,
  // plane i = space * nsides + side, so pair k's copy of plane i is
  // out plane (i - side) * npair + k * nsides + side
  int npair, nsides;
  // slope and fronts per column step of the launch's space: A/B (slope,
  // 1), V (0, 1), the parity spaces PA/PB (1, 2)
  int slope, fstep;
  int mgm, mode, use_fh, accumulate, reverse;  // mode: MGM_COST_*
  // FH with per-pixel windows: each message's input is masked with the
  // target pixel's window (update_costW_trunclinear, mgm_core.cc:229)
  int fh_restrict;
  float tmax, p1, p2, kappa, inv_nw;           // inv_nw: census 1/nch
  // plane i: label-0 disparity, label window, skew origin and sign
  // (col = (t - a0 + ssgn * slope * r) / fstep, the row sitting out
  // fronts where that does not divide), side, whether it folds
  // kappa*CC, and the recursions that sum into it, in recursion order.
  // The small tables are bytes: the struct goes with every launch, and
  // bytes keep it at 888 (int tables: 2,708).
  int plane_gmin[MGM_MAX_PLANES], plane_lo[MGM_MAX_PLANES];
  int plane_hi[MGM_MAX_PLANES], plane_a0[MGM_MAX_PLANES];
  signed char plane_side[MGM_MAX_PLANES], plane_ssgn[MGM_MAX_PLANES];
  signed char plane_fold[MGM_MAX_PLANES], plane_nrec[MGM_MAX_PLANES];
  unsigned char plane_recs[MGM_MAX_PLANES][MGM_MAX_RECS];
  // recursion m: its coupled messages (indices into the combos), the
  // weight channel of each (w8's last axis), and border bits
  // (1 need_left, 2 need_right, 4 need_top, 8 need_bottom)
  unsigned char rec_ranks[MGM_MAX_RECS][MGM_MAX_RANKS];
  unsigned char rec_wch[MGM_MAX_RECS][MGM_MAX_RANKS];
  unsigned char rec_border[MGM_MAX_RECS];
  // combo k: front lag and row roll (the neighbour row is r - roll)
  signed char combo_lag[MGM_MAX_COMBOS], combo_roll[MGM_MAX_COMBOS];
};

// K1's launch plan (ops/cuda_fused.k1_plan): a (pair, plane) unit is
// `ncl` clusters of `cluster` CTAs, its rows in bands of `band` rows
// dealt to the unit's CTAs in turn, `rows` local rows a CTA
// (ceil(ceil(R / band) / (cluster * ncl)) * band, some past the image in
// the last bands), and `smem` bytes of dynamic shared memory a CTA (at
// least two ints a local row: its count of finished fronts and its
// entry in the row table).  The labels a lane and the warps a CTA follow
// from L and `rows` (csrc/fused_wavefront.cuh k1_lanes, k1_warps).
struct K1Plan {
  int cluster, ncl, rows, band, smem;
};

// K4's band of rows under row sharding (parallel/fused_shard.py); K1
// passes zeros.
struct BandTail {
  // (2 * G, Ml, L): the ring of the neighbour band's row that this
  // band's edge row reads, step s at entry s mod 2G (the tracks of the
  // blocks before and of this one), or 0 (rows outside the band read
  // +inf)
  const float* halo;
  float* ship;         // (G, Ml, L): row ship_row of each step, or 0
  int r0;              // image row of local row 0 (< 0 in a top apron)
  int Rl;              // local rows: the ring's
  int out_off, out_R;  // out holds local rows out_off .. out_off+out_R-1
  int ship_row;        // -1 without a ship track
  int G, step0, nsteps;  // the block: steps step0 .. step0 + nsteps - 1
};

// One block of K4: K1's launch (w.R the image's rows, w.hist/w.mins the
// band's (D + 1, Ml, Rl, L) ring, w.out (Mp, out_R, C, L)) on a band;
// the launch plan (K1Plan) is sized on the band's rows in the image.
struct BandParams {
  WaveParams w;
  BandTail b;
};

#define MGM_MAX_OFFS 5
#define MGM_MAX_PASSES 4

// Dense MGM recursion over one canonical pass group (K5), read from and
// written to image layout: plane m = b * N + n is pass b of image n, and
// its canonical pixel (r, c) is image pixel
// pix = n * H * W + origin[b] + r * dr[b] + c * dc[b] (signed strides in
// pixels: ops/aggregate.pass_map).
struct ScanParams {
  const float* cc;     // (N, H, W, L) costs at pix * L
  float* out;          // (B, N, H, W, L) each pass's aggregated volume, at
                       // (b * N * H * W + pix) * L
  float* mins;         // (M, R, C) minimum over labels of each pixel
  const float* w8;     // (N, H, W, 8) edge weights at pix * 8 + channel,
                       // or 0
  const int* lo;       // (N, H, W) FH label windows at pix, or 0
  const int* hi;
  // K5 on a band (BAND): the row above the band (the upstream rank's last
  // row), its global front s at entry s mod 2G, values (2G, M, L) and
  // minima (2G, M), or 0 for the first band; the band's last row's values
  // (G, M, L) and minima (G, M) at the block's fronts, or 0
  const float* halo;
  const float* halo_m;
  float* ship;
  float* ship_m;
  int B, N, H, W;      // passes, images and the image's size
  int M, R, C, L;      // M = B * N planes of R x C canonical pixels
  int slope, mgm, knight, use_fh, use_weights, fh_restrict;
  float p1, p2;
  // offset rank k (offsets in ascending id order): front lag and
  // whether the neighbour lies one row up; coupled dir j -> offset rank
  int noffs;
  int off_lag[MGM_MAX_OFFS], off_shift[MGM_MAX_OFFS];
  int dir_rank[MGM_MAX_RANKS];
  // pass b's orientation map, and its weight channel (w8's last axis)
  // of each offset rank
  int origin[MGM_MAX_PASSES], dr[MGM_MAX_PASSES], dc[MGM_MAX_PASSES];
  int wch[MGM_MAX_PASSES][MGM_MAX_OFFS];
  // pass b's first real canonical row, first real column and real
  // columns: the pixels that aggregate (0, 0, C without mesh padding rows)
  int row0[MGM_MAX_PASSES], col0[MGM_MAX_PASSES], c1[MGM_MAX_PASSES];
  // BAND: the global canonical row of the band's row 0, the block's first
  // front and its fronts (front t holds column t - slope * global row)
  int r0, t0, G;
};

// K5's launch plan (ops/wavefront.k5_plan): `ctas` CTAs of `warps` warps,
// all resident at once.  The rows come in bands of `warps` rows of one
// plane group (a warp a row of 32 / NL planes); band beta is rows
// (beta / MP) * warps ... of plane group beta % MP (MP plane groups) and
// goes to CTA beta mod ctas, its row j to warp j; `smem` bytes of
// dynamic shared memory a CTA (each warp's ring of its row's last
// columns and its count: ops/wavefront._k5_warp_smem).
struct K5Plan {
  int ctas, warps, smem;
};

// Cross-space sum + windowed winner-take-all (K2).
struct WtaParams {
  const float* vol;    // (nspaces * N, R, C, L), space-major planes
  float* disp;         // (N, R, C)
  float* cost;         // (N, R, C)
  float* taps;         // (N, R, 4, C) S[oc-1 .. oc+2], or 0
  // N = pairs * nsides: side n takes the windows of table entry
  // n % nsides (every pair of a batch has the same sides)
  int N, nsides, nspaces, R, C, L;
  int side_gmin[MGM_MAX_SIDES], side_lo[MGM_MAX_SIDES],
      side_hi[MGM_MAX_SIDES];
  // the launch plan (ops/cuda_fused.k2_plan): pixels a run (a multiple
  // of 4 dividing 256, at most 64), shared-memory stages, and dynamic
  // shared memory bytes a CTA
  int run, stages, smem;
};

// Pointwise cost families of K1 and K8 (the order of cuda_cost.MODES).
#define MGM_COST_AD 0
#define MGM_COST_SD 1
#define MGM_COST_CENSUS 2
#define MGM_COST_BTAD 3
#define MGM_COST_BTSD 4

// The finished dense cost volume of one image pair (K8): raw costs, the
// truncation, the label windows and the all-invalid rule in one pass.
struct CostParams {
  const void* left;    // (H, W, nch) float32, or int32 census words
  const void* right;   // the same for the right image
  const int* lo;       // (H, W) label windows
  const int* hi;
  float* out;          // (H, W, L), labels fastest
  int H, W, L, nch;    // nch: channels; BT: 3 blocks [I, Imin, Imax]
  int gmin, mode;      // disparity of label 0; MGM_COST_*
  float inv_nw;        // census: 1 / nch
  float tmax;          // the truncation (and the cost off the image)
  // the launch plan (ops/cuda_cost.k8_plan): pixels a CTA's run, and
  // dynamic shared memory bytes a CTA
  int tx, smem;
};
