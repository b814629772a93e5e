/* B7 and B8: concentration in the TPU decode kernels' tiled staging layout,
 * as scatters.
 *
 * The layout: a plane of shape (blocks, R * sb, lanes) holds, at row
 * slot * sb + s and lane l of block b, slot `slot` of segment
 * (b, s * lanes + l). Every (b, s, l) is an independent row of R slots.
 *
 * B7 replaces deltarice_tpu/ops/concentrate_pallas.py::_tconc_low_kernel
 * and _tconc_high_kernel (driven by concentrate_tiled): one packed int32
 * leader disp << 16 | halfword (dead INT32_MIN, disp < 2^15) with an
 * optional int16 follower (the low halfword of a 32-bit payload), or one
 * sign-biased plane ((disp << 16) | halfword) ^ 2^31 (disp < 2^16, dead
 * INT32_MIN). Output is int16 samples (the halfword) or uint32 words
 * (leader halfword << 16 | follower halfword; the biased plane's halfword
 * zero-extended).
 *
 * B8 replaces _tvd_low_kernel, _tvd_mid_kernel and _tvd_high_kernel
 * (driven by concentrate_tiled_vd): an int16 payload plane and an int32
 * displacement plane (>= 0 live, negative dead), any displacement.
 *
 * On the TPU both are Nassimi-Sahni butterflies whose passes are sublane
 * shifts by (1 << b) * sb rows, in up to three VMEM levels. A GPU thread
 * stores anywhere: each live slot j of a row writes its payload to slot
 * j - disp of the same row. Destinations are distinct and increase with j,
 * so no two stores conflict; slots nothing reaches keep the zero the caller
 * filled, and destinations at or past the output's slot count are dropped.
 * The biased plane's dead marker is also a live 0 at displacement 0, which
 * is skipped for the reason given in concentrate_wide.cu.
 *
 * Bound: device-memory bandwidth. Threads walk the flat plane, so a warp
 * reads 32 neighbouring lanes of one row; the stores of a warp go to one
 * output row when its lanes share a displacement, and scatter otherwise.
 */
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int64_t kMaxGrid = 1 << 20;

enum Mode { kPacked = 0, kBiased = 1 };

/* Decode element i of a (blocks, rows_in, lanes) plane into its
 * (block, slot, s, lane) coordinates. */
struct Coord {
  int64_t b, slot, s, lane;
};

__device__ __forceinline__ Coord coord(int64_t i, int64_t rows_in,
                                       int64_t sb, int64_t lanes) {
  Coord c;
  c.lane = i % lanes;
  const int64_t row = (i / lanes) % rows_in;
  c.b = i / (lanes * rows_in);
  c.slot = row / sb;
  c.s = row - c.slot * sb;
  return c;
}

__device__ __forceinline__ int64_t out_index(const Coord &c, int64_t dest,
                                             int64_t rows_out, int64_t sb,
                                             int64_t lanes) {
  return (c.b * rows_out + dest * sb + c.s) * lanes + c.lane;
}

__global__ void tiled_kernel(const int32_t *__restrict__ lead,
                             const int16_t *__restrict__ follow,
                             int16_t *__restrict__ out16,
                             int32_t *__restrict__ out32, int64_t n,
                             int64_t rows_in, int64_t rows_out, int64_t sb,
                             int64_t lanes, int mode) {
  const int64_t slots_out = rows_out / sb;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t p = lead[i];
    if (p == INT32_MIN) continue;  // dead (or, biased, a live 0 at disp 0)
    uint32_t q = (uint32_t)p;
    if (mode == kBiased) q ^= 0x80000000u;
    const Coord c = coord(i, rows_in, sb, lanes);
    const int64_t dest = c.slot - (int64_t)(q >> 16);
    if (dest < 0 || dest >= slots_out) continue;
    const int64_t o = out_index(c, dest, rows_out, sb, lanes);
    const uint32_t half = q & 0xFFFFu;
    if (out16 != nullptr) {
      out16[o] = (int16_t)(uint16_t)half;
    } else if (follow != nullptr) {
      out32[o] = (int32_t)((half << 16) | ((uint32_t)(uint16_t)follow[i]));
    } else {
      out32[o] = (int32_t)half;
    }
  }
}

__global__ void tiled_vd_kernel(const int16_t *__restrict__ values,
                                const int32_t *__restrict__ disp,
                                int16_t *__restrict__ out, int64_t n,
                                int64_t rows_in, int64_t rows_out, int64_t sb,
                                int64_t lanes) {
  const int64_t slots_out = rows_out / sb;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t d = disp[i];
    if (d < 0) continue;
    const Coord c = coord(i, rows_in, sb, lanes);
    const int64_t dest = c.slot - d;
    if (dest < 0 || dest >= slots_out) continue;
    out[out_index(c, dest, rows_out, sb, lanes)] = values[i];
  }
}

unsigned grid_for(int64_t n) {
  int64_t g = (n + kBlock - 1) / kBlock;
  return (unsigned)(g < kMaxGrid ? g : kMaxGrid);
}

}  // namespace

extern "C" int dr_concentrate_tiled(const int32_t *lead, const int16_t *follow,
                                    void *out, int64_t blocks, int64_t rows_in,
                                    int64_t lanes, int64_t rows_out,
                                    int64_t sb, int mode, int emit_u32,
                                    void *stream) {
  const int64_t n = blocks * rows_in * lanes;
  if (n <= 0 || rows_out <= 0) return (int)cudaSuccess;
  if (sb <= 0 || rows_in % sb || rows_out % sb) return (int)cudaErrorInvalidValue;
  int16_t *out16 = emit_u32 ? nullptr : (int16_t *)out;
  int32_t *out32 = emit_u32 ? (int32_t *)out : nullptr;
  tiled_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      lead, follow, out16, out32, n, rows_in, rows_out, sb, lanes, mode);
  return (int)cudaGetLastError();
}

extern "C" int dr_concentrate_tiled_vd(const int16_t *values,
                                       const int32_t *disp, int16_t *out,
                                       int64_t blocks, int64_t rows_in,
                                       int64_t lanes, int64_t rows_out,
                                       int64_t sb, void *stream) {
  const int64_t n = blocks * rows_in * lanes;
  if (n <= 0 || rows_out <= 0) return (int)cudaSuccess;
  if (sb <= 0 || rows_in % sb || rows_out % sb) return (int)cudaErrorInvalidValue;
  tiled_vd_kernel<<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      values, disp, out, n, rows_in, rows_out, sb, lanes);
  return (int)cudaGetLastError();
}
