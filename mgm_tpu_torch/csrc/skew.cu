// K6 and K7: the diagonal skew copy and its inverse.
//
// Replace the TPU kernels mgm_tpu/ops/pallas_wavefront.py:_skew_kernel
// (launched by skew_p, pallas_wavefront.py:79) and :_unskew_kernel
// (unskew_p, :107).  Skew: (A, R, C, B) -> (A, R, T, B) with
// out[a, r, slope*r + c, b] = x[a, r, c, b] and `fill` elsewhere,
// T = C + slope*(R-1).  Unskew reads the same cells back into
// (A, R, C, B).  Elements are 32-bit words copied as bits, so one
// kernel serves float32 costs and weights and int32 label windows.
//
// What is not carried over: the TPU's 8/slope row blocks, the padded
// row count Rp, the +8 store margin and t_round (Mosaic's sublane
// alignment rules).  Here each (a, r) row is one contiguous span on
// both sides: the skewed row holds the image row's C*B words at word
// offset slope*r*B and fill around them.  Blocks stride along a row,
// one thread per output word, so loads and stores are coalesced and no
// thread divides.
//
// Bound: bytes.  Skew reads A*R*C*B words and writes A*R*T*B; unskew
// reads the A*R*C*B words it keeps and writes as many.
#include <cuda_runtime.h>

// src rows of `in` words, dst rows of `out` words; dst word j of row
// (a, r) is src word j - off (off = slope*r*B for skew, -slope*r*B for
// unskew) when that lies in [0, in), else `fill`.
__global__ void shift_rows(const unsigned* __restrict__ src,
                           unsigned* __restrict__ dst, long long rows, int R,
                           int in, int out, int step, unsigned fill) {
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const int off = (int)(row % R) * step;
    const unsigned* s = src + row * in;
    unsigned* d = dst + row * out;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < out;
         j += gridDim.x * blockDim.x) {
      const int i = j - off;
      d[j] = (i >= 0 && i < in) ? s[i] : fill;
    }
  }
}

// inverse = 0: skew src (A, R, C, B) into dst (A, R, T, B);
// inverse = 1: unskew src (A, R, T, B) into dst (A, R, C, B).
// Returns the launch's CUDA error (0 when it was accepted).
extern "C" int mgm_skew(const void* src, void* dst, long long A, int R, int C,
                        int T, int B, int slope, unsigned fill, int inverse,
                        void* stream) {
  if (A < 1 || R < 1 || C < 1 || B < 1 || slope < 0 ||
      T != C + slope * (R - 1) || (long long)T * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int wide = T * B, narrow = C * B;
  const int out = inverse ? narrow : wide;
  const int threads = 256;
  const int bx = (out + threads - 1) / threads;
  const long long rows = A * R;
  const dim3 grid(bx < 64 ? bx : 64, rows < 65535 ? (unsigned)rows : 65535);
  shift_rows<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)src, (unsigned*)dst, rows, R, inverse ? wide : narrow,
      out, (inverse ? -1 : 1) * slope * B, fill);
  return (int)cudaGetLastError();
}
