/* B4: tiled 2-D transpose (A, B) -> (B, A).
 *
 * Replaces deltarice_tpu/ops/transpose_pallas.py::_tr_kernel (driven by
 * transpose2d). The TPU needed it to move data between segment-major rows
 * and its lane layout. The port's codec kernels (B1, B2, B9) all read the
 * codec's segment-major arrays, so no codec path launches it.
 *
 * Bound: device-memory bandwidth (one read and one write of every element,
 * no arithmetic). A naive transpose makes one of the two sides strided; a
 * 32x32 tile staged in shared memory lets a warp read a row segment and
 * write a row segment of the output, both contiguous. The tile carries one
 * column of padding so the column-wise shared-memory reads hit 32 different
 * banks for 4-byte elements. Ragged edges are masked; the grid's y
 * dimension strides over row tiles so any A fits its 65535 limit.
 */
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // threads per block: kTile x kRows

template <typename T>
__global__ void transpose_kernel(const T *__restrict__ x, T *__restrict__ out,
                                 int64_t a, int64_t b) {
  __shared__ T tile[kTile][kTile + 1];
  const int64_t col0 = (int64_t)blockIdx.x * kTile;  // along b
  for (int64_t row0 = (int64_t)blockIdx.y * kTile; row0 < a;
       row0 += (int64_t)gridDim.y * kTile) {
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int64_t r = row0 + j, c = col0 + threadIdx.x;
      if (r < a && c < b) tile[j][threadIdx.x] = x[r * b + c];
    }
    __syncthreads();
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int64_t r = col0 + j, c = row0 + threadIdx.x;  // out is (b, a)
      if (r < b && c < a) out[r * a + c] = tile[threadIdx.x][j];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dr_transpose2d(const void *x, void *out, int64_t a, int64_t b,
                              int elem_size, void *stream) {
  if (a <= 0 || b <= 0) return (int)cudaSuccess;
  const int64_t tiles_b = (b + kTile - 1) / kTile;
  const int64_t tiles_a = (a + kTile - 1) / kTile;
  dim3 grid((unsigned)tiles_b, (unsigned)(tiles_a < 65535 ? tiles_a : 65535));
  dim3 block(kTile, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 2) {
    transpose_kernel<int16_t><<<grid, block, 0, s>>>(
        (const int16_t *)x, (int16_t *)out, a, b);
  } else if (elem_size == 4) {
    transpose_kernel<int32_t><<<grid, block, 0, s>>>(
        (const int32_t *)x, (int32_t *)out, a, b);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
