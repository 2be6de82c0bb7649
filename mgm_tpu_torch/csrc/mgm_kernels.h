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
  const float* left;   // (N, R, C, nch) left image of each side
  const float* right;  // (N, R, C, nch) right image of each side
  float* out;          // (Mp, R, C, L) per-plane sums, image layout
  float* hist;         // (D + 1, Ml, R, L) ring of per-recursion fronts
  float* mins;         // (D + 1, Ml, R) their minima over labels
  int R, C, L, nch;
  int Mp, Ml, D;       // planes, recursions, deepest front lag
  int slope, mgm, sd, accumulate, reverse;
  float tmax, p1, p2, kappa;
  // plane i: side, label-0 disparity, label window, skew origin and
  // sign (col = t - a0 + ssgn * slope * r), whether it folds kappa*CC,
  // and the recursions that sum into it, in recursion order
  int plane_side[MGM_MAX_PLANES], plane_gmin[MGM_MAX_PLANES];
  int plane_lo[MGM_MAX_PLANES], plane_hi[MGM_MAX_PLANES];
  int plane_a0[MGM_MAX_PLANES], plane_ssgn[MGM_MAX_PLANES];
  int plane_fold[MGM_MAX_PLANES], plane_nrec[MGM_MAX_PLANES];
  int plane_recs[MGM_MAX_PLANES][MGM_MAX_RECS];
  // recursion m: its coupled messages (indices into the combos) and
  // border bits (1 need_left, 2 need_right, 4 need_top, 8 need_bottom)
  int rec_ranks[MGM_MAX_RECS][MGM_MAX_RANKS];
  int rec_border[MGM_MAX_RECS];
  // combo k: front lag and row roll (the neighbour row is r - roll)
  int combo_lag[MGM_MAX_COMBOS], combo_roll[MGM_MAX_COMBOS];
};

#define MGM_MAX_OFFS 5

// Dense MGM recursion over one skewed canonical pass group (K5).
struct ScanParams {
  float* vol;          // (M, R, T, L) skewed costs in, aggregated out
  float* mins;         // (M, R, T) minimum over labels of each cell
  const float* w;      // (noffs * M, R, T) weights per offset rank, or 0
  const int* lo;       // (M, R, T) FH label windows, or 0
  const int* hi;
  int M, R, T, C, L;
  int slope, mgm, knight, use_fh, use_weights, fh_restrict;
  float p1, p2;
  // offset rank k (offsets in ascending id order): front lag and
  // whether the neighbour lies one row up; coupled dir j -> offset rank
  int noffs;
  int off_lag[MGM_MAX_OFFS], off_shift[MGM_MAX_OFFS];
  int dir_rank[MGM_MAX_RANKS];
};

// Cross-space sum + windowed winner-take-all (K2).
struct WtaParams {
  const float* vol;    // (nspaces * N, R, C, L), space-major planes
  float* disp;         // (N, R, C)
  float* cost;         // (N, R, C)
  int N, nspaces, R, C, L;
  int side_gmin[MGM_MAX_SIDES], side_lo[MGM_MAX_SIDES],
      side_hi[MGM_MAX_SIDES];
};
