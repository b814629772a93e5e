/* B5 and B6: concentration of slot axes too wide for the packed planes
 * (>= 2^15 slots, or displacements >= 2^15), as scatters.
 *
 * B5 replaces deltarice_tpu/ops/concentrate_pallas.py::_wide_kernel and
 * _high_kernel (driven by _concentrate_wide): two explicit int32 planes,
 * a payload and a displacement (>= 0 live, negative dead), any slot axis
 * and any displacement. The sub-stream merge of NOPTREX-length segments
 * (32 parts x ~2048 words) takes it.
 *
 * B6 replaces _wide16_low_kernel and _wide16_high_kernel (driven by
 * concentrate_wide16_plane): one sign-biased plane
 * ((disp << 16) | halfword) ^ 2^31 with dead slots INT32_MIN, for payloads
 * of at most 16 bits and displacements below 2^16. The split decode's
 * ragged row merge (_compose_merge) takes it. Output is the halfword,
 * zero-extended; the caller casts.
 *
 * On the TPU both are Nassimi-Sahni butterflies (log2(R) shift-and-select
 * passes, low strides over a two-block halo in VMEM, block strides over
 * column stripes), because a TPU vector store cannot go to a per-lane
 * address. A GPU thread can store anywhere: each live slot j writes its
 * payload to j - disp. Destinations are distinct and increase with j, so
 * no two stores conflict and no atomics or ordering are needed; slots that
 * nothing reaches keep the zero the caller filled, and stores at or past
 * n_out are dropped.
 *
 * B6's dead marker INT32_MIN is also the image of a live element with
 * value 0 at displacement 0. Such an element is skipped like a dead one,
 * and its destination (its own slot) keeps the zero fill, which is its
 * value; storing it instead could race with the live element that really
 * lands there.
 *
 * Bound: device-memory bandwidth (one coalesced read of each plane, one
 * store per live slot). The grid is flattened over (row, column block) so
 * that a few hundred long rows still fill 132 SMs.
 */
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int64_t kCols = 4096;  // slots per thread block

__device__ __forceinline__ void block_span(int64_t r, int64_t *row,
                                           int64_t *j0, int64_t *j1) {
  const int64_t nb = (r + kCols - 1) / kCols;
  *row = (int64_t)blockIdx.x / nb;
  *j0 = ((int64_t)blockIdx.x - *row * nb) * kCols;
  *j1 = *j0 + kCols < r ? *j0 + kCols : r;
}

__global__ void wide_kernel(const int32_t *__restrict__ values,
                            const int32_t *__restrict__ disp,
                            int32_t *__restrict__ out, int64_t r,
                            int64_t n_out) {
  int64_t row, j0, j1;
  block_span(r, &row, &j0, &j1);
  const int32_t *v = values + row * r;
  const int32_t *d = disp + row * r;
  int32_t *o = out + row * n_out;
  for (int64_t j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int32_t dj = d[j];
    if (dj < 0) continue;
    const int64_t dest = j - dj;
    if (dest >= 0 && dest < n_out) o[dest] = v[j];
  }
}

__global__ void wide16_kernel(const int32_t *__restrict__ plane,
                              int32_t *__restrict__ out, int64_t r,
                              int64_t n_out) {
  int64_t row, j0, j1;
  block_span(r, &row, &j0, &j1);
  const int32_t *p = plane + row * r;
  int32_t *o = out + row * n_out;
  for (int64_t j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int32_t pj = p[j];
    if (pj == INT32_MIN) continue;  // dead, or a live 0 at displacement 0
    const uint32_t q = (uint32_t)pj ^ 0x80000000u;
    const int64_t dest = j - (int64_t)(q >> 16);
    if (dest >= 0 && dest < n_out) o[dest] = (int32_t)(q & 0xFFFFu);
  }
}

int grid_blocks(int64_t rows, int64_t r, unsigned *blocks) {
  const int64_t n = rows * ((r + kCols - 1) / kCols);
  if (n > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int dr_concentrate_wide(const int32_t *values, const int32_t *disp,
                                   int32_t *out, int64_t rows, int64_t r,
                                   int64_t n_out, void *stream) {
  if (rows <= 0 || r <= 0 || n_out <= 0) return (int)cudaSuccess;
  unsigned blocks;
  const int rc = grid_blocks(rows, r, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  wide_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(values, disp, out,
                                                           r, n_out);
  return (int)cudaGetLastError();
}

extern "C" int dr_concentrate_wide16(const int32_t *plane, int32_t *out,
                                     int64_t rows, int64_t r, int64_t n_out,
                                     void *stream) {
  if (rows <= 0 || r <= 0 || n_out <= 0) return (int)cudaSuccess;
  unsigned blocks;
  const int rc = grid_blocks(rows, r, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  wide16_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(plane, out, r,
                                                             n_out);
  return (int)cudaGetLastError();
}
