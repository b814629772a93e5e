/* B3: packed concentration ("sorted with gaps" -> dense) as a scatter.
 *
 * Replaces deltarice_tpu/ops/concentrate_pallas.py::_conc_kernel (driven by
 * _run and concentrate_packed). A TPU vector unit cannot store to a
 * per-lane address, so the TPU compacts each row with a Nassimi-Sahni
 * butterfly: log2(R) shift-and-select passes over the row held in VMEM.
 * A GPU thread can store anywhere, so each live slot j simply writes its
 * payload to j - disp. Destinations are distinct and increase with j, so
 * no two stores conflict and no ordering or atomics are needed; slots that
 * nothing reaches keep the zero the caller filled.
 *
 * Input planes follow the TPU contract: an int32 leader
 * disp << 16 | halfword with dead slots INT32_MIN (disp < 2^15, so live
 * leaders are non-negative), and an optional int16 follower carrying the
 * low halfword of a 32-bit payload.
 *
 * Bound: device-memory bandwidth — one coalesced read of each plane and
 * one store per live slot. One block per row; its threads stride over the
 * row's slots, so reads are coalesced and the stores of a warp land in a
 * short run of the output row.
 */
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int32_t kDead = INT32_MIN;

__global__ void concentrate_kernel(const int32_t *__restrict__ lead,
                                   const int16_t *__restrict__ follow,
                                   uint32_t *__restrict__ out, int64_t r,
                                   int64_t n_out) {
  const int64_t row = blockIdx.x;
  const int32_t *lrow = lead + row * r;
  const int16_t *frow = follow ? follow + row * r : nullptr;
  uint32_t *orow = out + row * n_out;
  for (int64_t j = threadIdx.x; j < r; j += blockDim.x) {
    const int32_t v = lrow[j];
    if (v == kDead) continue;
    const int64_t dest = j - (int64_t)(v >> 16);
    if (dest < 0 || dest >= n_out) continue;
    const uint32_t half = (uint32_t)v & 0xFFFFu;
    orow[dest] = frow ? (half << 16) | (uint16_t)frow[j] : half;
  }
}

}  // namespace

extern "C" int dr_concentrate_packed(const int32_t *lead,
                                     const int16_t *follow, int32_t *out,
                                     int64_t rows, int64_t r, int64_t n_out,
                                     void *stream) {
  if (rows <= 0 || r <= 0 || n_out <= 0) return (int)cudaSuccess;
  if (rows > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  concentrate_kernel<<<(unsigned)rows, kBlock, 0, (cudaStream_t)stream>>>(
      lead, follow, (uint32_t *)out, r, n_out);
  return (int)cudaGetLastError();
}
