/* The generic pre-filter inverse: every filter but the delta, whose
 * inverse B2 fuses.
 *
 * Replaces deltarice_tpu/ops/prefilter.py::_iir_decode, which is no Pallas
 * kernel but a jitted lax.scan: XLA compiles it into one device loop over
 * the samples, every row of the batch in each step. Per row:
 *
 *   out[i] = wrap16(d[i] - sum_{j>=1} c16(filt[j]) * out[i - j]) / f0,
 *
 * f0 = c16(filt[0]), out[i - j] = 0 before the row starts, the division
 * truncating toward zero on the wrapped int16 numerator (C's, and
 * lax.div's), the quotient wrapped to int16 (-32768 / -1 gives -32768).
 * f0 == 0 gives -1, XLA's signed division by zero; f0 == +-1 skips the
 * division. Products and sums run in uint32 (mod 2^32, which agrees mod
 * 2^16 and cannot overflow); only the int16 numerator is divided.
 *
 * Design: one thread walks one row serially, so the recurrence costs a
 * dependent multiply-add and a sign extension a sample (plus the division
 * where |f0| != 1). A block is one warp and owns 32 rows. It stages tiles
 * of 32 rows x 256 samples into shared memory 16 bytes a lane by cp.async,
 * the next tile in flight while the warp walks the current one in place,
 * and writes each tile back 16 bytes a lane: neither the loads nor the
 * stores stride by a row. The walker reads and writes its row 8 samples
 * (16 bytes) at a time; the row pitch of 264 int16s (528 bytes, 132
 * words) puts the 8 lanes of each quarter-warp on distinct 4-bank groups,
 * so those 128-bit accesses are free of bank conflicts. With f0 == +-1 the
 * sign folds into the taps and the input, so no multiply by it sits on the
 * chain. Up to 8 history taps (a template on their count) live in
 * registers; longer filters keep taps and history in shared memory. Rows
 * whose length is not a multiple of 8, or pointers off a 16-byte boundary,
 * take element-wise staging with the same walk.
 *
 * Bound: device-memory bytes (each sample read once and written once),
 * far below what this design reaches: the walk is a serial chain of a few
 * cycles a sample, and 32 rows a warp leave most SMs idle below a few
 * thousand rows. A blocked parallel scan (the recurrence is linear over
 * Z/2^16 when f0 == +-1) is the redesign that would approach the bound.
 */
#include <cuda_runtime.h>

#include <type_traits>

#include "kernels.h"

namespace {

constexpr int kRows = 32;              // rows of a tile: one per lane
constexpr int kSamples = 256;          // samples of a tile
constexpr int kPitch = kSamples + 8;   // int16s per shared row (528 bytes)
constexpr int kTile = kRows * kPitch;  // int16s of one tile buffer
constexpr int kTileBytes = 2 * kTile * 2;  // two buffers
constexpr int kRegTaps = 8;            // history taps kept in registers
constexpr int kMaxHistory = DR_IIR_MAX_TAPS - 1;

bool aligned16(const void *p) { return ((uintptr_t)p & 15u) == 0; }

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the next tile) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

/* The quotient of the wrapped numerator, as int16. */
template <bool kDivide>
__device__ __forceinline__ int16_t finish(uint32_t acc, int32_t f0) {
  const int32_t num = (int16_t)acc;
  if constexpr (kDivide) return (int16_t)(f0 != 0 ? num / f0 : -1);
  return (int16_t)num;
}

/* History of kHist taps in registers; c[j] multiplies out[i - 1 - j]. */
template <int kHist, bool kDivide>
struct RegWalker {
  uint32_t c[kHist > 0 ? kHist : 1];
  uint32_t h[kHist > 0 ? kHist : 1];

  __device__ void init(const int16_t *__restrict__ taps, uint32_t sgn,
                       uint32_t *, int, int) {
#pragma unroll
    for (int j = 0; j < kHist; ++j) {
      c[j] = sgn * (uint32_t)(int32_t)taps[j];
      h[j] = 0;
    }
  }

  __device__ __forceinline__ int16_t step(int16_t din, uint32_t sgn,
                                          int32_t f0) {
    uint32_t acc = sgn * (uint32_t)(int32_t)din;
    // the newest output last: one multiply-add on the recurrence's chain
#pragma unroll
    for (int j = kHist - 1; j >= 0; --j) acc -= c[j] * h[j];
    const int16_t r = finish<kDivide>(acc, f0);
#pragma unroll
    for (int j = kHist - 1; j > 0; --j) h[j] = h[j - 1];
    if constexpr (kHist > 0) h[0] = (uint32_t)(int32_t)r;
    return r;
  }
};

/* Any number of taps: taps at cs[j], the lane's history a ring of nhist
 * entries at hs[slot * kRows + lane] (lane-minor: no bank conflicts). */
template <bool kDivide>
struct SharedWalker {
  const uint32_t *cs;
  uint32_t *hs;
  int nhist, pos, lane;

  __device__ void init(const int16_t *__restrict__ taps, uint32_t sgn,
                       uint32_t *shared, int nhist_, int lane_) {
    nhist = nhist_;
    lane = lane_;
    pos = 0;
    uint32_t *c = shared;
    hs = shared + nhist;
    cs = c;
    for (int j = lane; j < nhist; j += 32)
      c[j] = sgn * (uint32_t)(int32_t)taps[j];
    for (int j = 0; j < nhist; ++j) hs[j * kRows + lane] = 0;
    __syncwarp();
  }

  __device__ __forceinline__ int16_t step(int16_t din, uint32_t sgn,
                                          int32_t f0) {
    uint32_t acc = sgn * (uint32_t)(int32_t)din;
    int q = pos;  // the newest output sits one slot before pos
    for (int j = 0; j < nhist; ++j) {
      q = (q == 0 ? nhist : q) - 1;
      acc -= cs[j] * hs[q * kRows + lane];
    }
    const int16_t r = finish<kDivide>(acc, f0);
    hs[pos * kRows + lane] = (uint32_t)(int32_t)r;  // over the oldest
    pos = pos + 1 == nhist ? 0 : pos + 1;
    return r;
  }
};

template <int kHist, bool kDivide>
using Walker = typename std::conditional<kHist < 0, SharedWalker<kDivide>,
                                         RegWalker<kHist, kDivide>>::type;

/* Block b inverts rows [32 b, 32 b + 32) of d (rows, n) into out. vec:
 * 16-byte staging (n a multiple of 8, d and out 16-byte aligned); else
 * element-wise. kHist < 0: taps and history in shared memory. */
template <int kHist, bool kDivide>
__global__ void __launch_bounds__(kRows)
    iir_kernel(const int16_t *__restrict__ d, int16_t *__restrict__ out,
               const int16_t *__restrict__ taps, int nhist, int32_t f0,
               int64_t rows, int64_t n, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t *tiles = reinterpret_cast<int16_t *>(smem);
  const int lane = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int nrows = (int)(rows - row0 < kRows ? rows - row0 : kRows);
  const int64_t ntiles = (n + kSamples - 1) / kSamples;
  // f0 == +-1: fold its sign into the input and the taps, divide by nothing
  const uint32_t sgn = kDivide ? 1u : (uint32_t)f0;

  Walker<kHist, kDivide> walker;
  walker.init(taps, sgn, reinterpret_cast<uint32_t *>(smem + kTileBytes),
              nhist, lane);

  auto tile_len = [&](int64_t t) {
    const int64_t left = n - t * kSamples;
    return (int)(left < kSamples ? left : kSamples);
  };
  auto load = [&](int64_t t) {
    int16_t *tile = tiles + (t & 1) * kTile;
    const int64_t s0 = t * kSamples;
    const int len = tile_len(t);
    if (vec) {
      if (lane * 8 < len)
        for (int r = 0; r < nrows; ++r)
          cp_async16(tile + r * kPitch + lane * 8,
                     d + (row0 + r) * n + s0 + lane * 8);
    } else {
      for (int r = 0; r < nrows; ++r)
        for (int i = lane; i < len; i += 32)
          tile[r * kPitch + i] = d[(row0 + r) * n + s0 + i];
    }
    cp_async_commit();
  };

  load(0);
  for (int64_t t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      load(t + 1);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_one();
    __syncwarp();
    int16_t *tile = tiles + (t & 1) * kTile;
    const int len = tile_len(t);
    if (lane < nrows) {
      // 8 samples a step of the loop; past len (the last tile only) the
      // walk runs on stale values that are never stored
      int16_t *row = tile + lane * kPitch;
      for (int g = 0; g < len; g += 8) {
        const uint4 q = *reinterpret_cast<const uint4 *>(row + g);
        uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int16_t lo = walker.step((int16_t)(w[k] & 0xFFFFu), sgn, f0);
          const int16_t hi = walker.step((int16_t)(w[k] >> 16), sgn, f0);
          w[k] = (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
        }
        *reinterpret_cast<uint4 *>(row + g) = make_uint4(w[0], w[1], w[2],
                                                         w[3]);
      }
    }
    __syncwarp();
    const int64_t s0 = t * kSamples;
    if (vec) {
      if (lane * 8 < len)
        for (int r = 0; r < nrows; ++r)
          *reinterpret_cast<uint4 *>(out + (row0 + r) * n + s0 + lane * 8) =
              *reinterpret_cast<const uint4 *>(tile + r * kPitch + lane * 8);
    } else {
      for (int r = 0; r < nrows; ++r)
        for (int i = lane; i < len; i += 32)
          out[(row0 + r) * n + s0 + i] = tile[r * kPitch + i];
    }
    __syncwarp();  // the tile is read out before the load of t + 2
  }
}

template <int kHist, bool kDivide>
int launch(const int16_t *d, int16_t *out, const int16_t *taps, int nhist,
           int32_t f0, int64_t rows, int64_t n, cudaStream_t s) {
  const int vec = n % 8 == 0 && aligned16(d) && aligned16(out);
  const int smem =
      kTileBytes + (kHist < 0 ? nhist * (kRows + 1) * (int)sizeof(uint32_t)
                              : 0);
  auto *kernel = iir_kernel<kHist, kDivide>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int64_t blocks = (rows + kRows - 1) / kRows;
  kernel<<<(unsigned)blocks, kRows, smem, s>>>(d, out, taps, nhist, f0, rows,
                                               n, vec);
  return (int)cudaGetLastError();
}

template <bool kDivide>
int dispatch(const int16_t *d, int16_t *out, const int16_t *taps, int nhist,
             int32_t f0, int64_t rows, int64_t n, cudaStream_t s) {
  static_assert(kRegTaps == 8, "one case per register history length");
  switch (nhist) {
    case 0: return launch<0, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 1: return launch<1, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 2: return launch<2, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 3: return launch<3, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 4: return launch<4, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 5: return launch<5, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 6: return launch<6, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 7: return launch<7, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    case 8: return launch<8, kDivide>(d, out, taps, nhist, f0, rows, n, s);
    default: return launch<-1, kDivide>(d, out, taps, nhist, f0, rows, n, s);
  }
}

}  // namespace

extern "C" int dr_iir_decode(const int16_t *d, int16_t *out,
                             const int16_t *taps, int64_t nhist, int f0,
                             int64_t rows, int64_t n, void *stream) {
  if (rows < 0 || n < 0 || nhist < 0 || nhist > kMaxHistory ||
      rows / kRows >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  const int32_t f = (int16_t)f0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 1 || f == -1)
    return dispatch<false>(d, out, taps, (int)nhist, f, rows, n, s);
  return dispatch<true>(d, out, taps, (int)nhist, f, rows, n, s);
}
