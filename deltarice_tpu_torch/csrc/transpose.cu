/* B4: transpose (N, A, B) -> (N, B, A) of 2- or 4-byte elements.
 *
 * Replaces deltarice_tpu/ops/transpose_pallas.py::_tr_kernel (driven by
 * transpose2d, and by jax.vmap of it over blocks of 1024 segments: the
 * JAX package moves its codec's data between segment-major rows and the
 * TPU's lane layout with it). The port's codec kernels (B1, B2, B9) all
 * read the codec's segment-major arrays, so no codec path launches it.
 *
 * Bound: device-memory bandwidth, every element read once and written
 * once, no arithmetic. What stands between a transpose and that bound,
 * and what the design does:
 *  - Access width. 2-byte loads and stores make a warp instruction move
 *    64 bytes. Here every global load and store is 16 bytes a thread
 *    (P = 8 int16 or 4 32-bit elements): a thread loads a P x P block, P
 *    pieces of one input column range on P consecutive rows, and a warp
 *    (4 x 8 threads) covers 4 P rows x 8 pieces, so each load instruction
 *    reads 128 bytes of each of 4 rows.
 *  - The turn. The block is turned in registers (int16: 32 __byte_perm,
 *    one per output word; 32-bit: a renaming of registers), so each of
 *    the thread's P pieces is now P elements of one output row. They go
 *    16 bytes at a time into a shared tile laid out in output order:
 *    TB output rows of 8 pieces (128 bytes). Reading the tile back, 8
 *    threads take the 8 pieces of one output row, so each store
 *    instruction writes 128 bytes of each of 4 output rows.
 *  - Banks. Piece j of tile row o sits at piece j ^ ((o / P) & 7) of its
 *    row (an XOR swizzle on 16-byte pieces). The 8 threads of a quarter
 *    warp write one piece index to 8 rows whose (o / P) & 7 differ, and
 *    read the 8 pieces of one row: either way they meet all 32 banks
 *    once, so each 16-byte shared access takes the least number of
 *    wavefronts (4).
 *  - Bytes in flight. A block of 256 threads tiles 8 P rows x 32 P
 *    columns (int16 64 x 256, 32 KB; 32-bit 32 x 128, 16 KB); each thread
 *    issues its P loads before it uses the first.
 *  - Edges. Pieces past A or B are masked (whole pieces: the vector path
 *    needs A and B multiples of P). Where a row pitch is not a multiple
 *    of 16 bytes, or a pointer is not 16-byte aligned, dr_transpose2d
 *    takes the element-wise path: 32 x 32 tiles, one element a thread,
 *    staged as 32-bit words in a padded tile (no bank conflicts).
 *  - Size. Offsets are 64-bit; a 1-D grid walks a linear tile index over
 *    (N, A tiles, B tiles), so no grid dimension meets its limit.
 * ops/transpose_model.py walks the same tiles, turn, swizzle and masks in
 * plain torch; dr_transpose_geometry and dr_transpose_vector_path give the
 * card tests this file's tile constants and path choice to hold the model
 * to. chip_smoke.py times the kernel warm and cold at the JAX
 * package's shapes and checks its SASS for 128-bit accesses.
 */
#include <cuda_runtime.h>

#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kBlock = 256;            // threads of a block
constexpr int kWarpsA = 2;             // warps of a block along A
constexpr int kLanesA = 4;             // threads of a warp along A
constexpr int kLanesB = 8;             // along B
constexpr int kWarpsB = kBlock / 32 / kWarpsA;
constexpr int kPieces = kWarpsA * kLanesA;  // 16-byte pieces of a tile row
constexpr int kEdgeTile = 32;          // element-wise path: 32 x 32 tiles
constexpr int kEdgeRows = 8;           // its threads: 32 x 8
constexpr int64_t kMaxGrid = 1 << 30;  // blocks of a launch (then a loop)

/* A thread's P x P block, P pieces of 4 words: rows in, columns out
 * (int16: word w of row k holds columns 2w and 2w + 1, low half first). */
template <int kP>
__device__ __forceinline__ void turn(const uint32_t (&in)[kP][4],
                                     uint32_t (&out)[kP][4]) {
  if constexpr (kP == 8) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int w = 0; w < 4; ++w)  // rows 2w and 2w + 1 of column c
        out[c][w] = __byte_perm(in[2 * w][c / 2], in[2 * w + 1][c / 2],
                                (c & 1) ? 0x7632 : 0x5410);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int w = 0; w < 4; ++w) out[c][w] = in[w][c];
  }
}

/* Blocks an SM must hold: int16 needs ~76 registers a thread to keep its
 * 64 words without spilling (ptxas spills at its own choice of 64). */
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 3 : 6;

/* The vector path: A and B multiples of P, x and out 16-byte aligned. */
template <typename T>
__global__ void __launch_bounds__(kBlock, kMinBlocks<T>)
    transpose_vec_kernel(const T *__restrict__ x, T *__restrict__ out,
                         int64_t a, int64_t b, int64_t tiles_b,
                         int64_t tiles_per, int64_t tiles) {
  constexpr int kP = 16 / (int)sizeof(T);  // elements of a piece
  constexpr int kTA = kPieces * kP;        // tile rows (along A)
  constexpr int kTB = kWarpsB * kLanesB * kP;  // tile columns (along B)
  constexpr int kStores = kTB * kPieces / kBlock;  // pieces a thread stores
  // kTB output rows of kPieces pieces, piece j of row o at j ^ ((o/P) & 7)
  __shared__ uint4 tile[kTB][kPieces];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pa = (warp % kWarpsA) * kLanesA + (lane >> 3);  // piece of A
  const int qb = (warp / kWarpsA) * kLanesB + (lane & 7);   // piece of B
  const int j = threadIdx.x % kPieces;  // the piece this thread stores
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t n = t / tiles_per, rem = t - n * tiles_per;
    const int64_t ta = rem / tiles_b;
    const int64_t r0 = ta * kTA, c0 = (rem - ta * tiles_b) * kTB;
    const T *xs = x + n * a * b;
    T *os = out + n * a * b;
    uint32_t in[kP][4], turned[kP][4];
    const int64_t r = r0 + pa * kP, c = c0 + qb * kP;
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r + k < a && c < b)
        v = __ldcs(reinterpret_cast<const uint4 *>(xs + (r + k) * b + c));
      in[k][0] = v.x;
      in[k][1] = v.y;
      in[k][2] = v.z;
      in[k][3] = v.w;
    }
    turn<kP>(in, turned);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int o = qb * kP + k;  // (o / P) & 7 == qb & 7
      tile[o][pa ^ (qb & 7)] = make_uint4(turned[k][0], turned[k][1],
                                          turned[k][2], turned[k][3]);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kStores; ++m) {
      const int o = threadIdx.x / kPieces + m * (kBlock / kPieces);
      const int64_t orow = c0 + o, ocol = r0 + j * kP;
      if (orow < b && ocol < a)
        *reinterpret_cast<uint4 *>(os + orow * a + ocol) =
            tile[o][j ^ ((o / kP) & 7)];
    }
    __syncthreads();
  }
}

/* The element-wise path: any A, B and alignment. */
template <typename T>
__global__ void transpose_edge_kernel(const T *__restrict__ x,
                                      T *__restrict__ out, int64_t a,
                                      int64_t b, int64_t tiles_b,
                                      int64_t tiles_per, int64_t tiles) {
  // 32-bit words, one column of padding: a warp reads a row or a column
  // of the tile from 32 banks
  __shared__ int32_t tile[kEdgeTile][kEdgeTile + 1];
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t n = t / tiles_per, rem = t - n * tiles_per;
    const int64_t ta = rem / tiles_b;
    const int64_t row0 = ta * kEdgeTile;
    const int64_t col0 = (rem - ta * tiles_b) * kEdgeTile;
    const T *xs = x + n * a * b;
    T *os = out + n * a * b;
    for (int j = threadIdx.y; j < kEdgeTile; j += kEdgeRows) {
      const int64_t r = row0 + j, c = col0 + threadIdx.x;
      if (r < a && c < b) tile[j][threadIdx.x] = xs[r * b + c];
    }
    __syncthreads();
    for (int j = threadIdx.y; j < kEdgeTile; j += kEdgeRows) {
      const int64_t r = col0 + j, c = row0 + threadIdx.x;  // out is (b, a)
      if (r < b && c < a) os[r * a + c] = (T)tile[threadIdx.x][j];
    }
    __syncthreads();
  }
}

bool aligned16(const void *p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void *x, void *out, int64_t n, int64_t a, int64_t b,
           cudaStream_t s) {
  constexpr int64_t kP = 16 / sizeof(T);
  const T *xt = static_cast<const T *>(x);
  T *ot = static_cast<T *>(out);
  if (dr_transpose_vector_path(x, out, a, b, sizeof(T))) {
    constexpr int64_t kTA = kPieces * kP, kTB = kWarpsB * kLanesB * kP;
    const int64_t tiles_b = (b + kTB - 1) / kTB;
    const int64_t per = (a + kTA - 1) / kTA * tiles_b;
    const int64_t tiles = n * per;
    transpose_vec_kernel<T><<<(unsigned)(tiles < kMaxGrid ? tiles : kMaxGrid),
                              kBlock, 0, s>>>(xt, ot, a, b, tiles_b, per,
                                              tiles);
  } else {
    const int64_t tiles_b = (b + kEdgeTile - 1) / kEdgeTile;
    const int64_t per = (a + kEdgeTile - 1) / kEdgeTile * tiles_b;
    const int64_t tiles = n * per;
    transpose_edge_kernel<T>
        <<<(unsigned)(tiles < kMaxGrid ? tiles : kMaxGrid),
           dim3(kEdgeTile, kEdgeRows), 0, s>>>(xt, ot, a, b, tiles_b, per,
                                               tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dr_transpose_vector_path(const void *x, const void *out,
                                        int64_t a, int64_t b, int elem_size) {
  const int64_t p = 16 / elem_size;
  return a % p == 0 && b % p == 0 && aligned16(x) && aligned16(out);
}

extern "C" int dr_transpose_geometry(int elem_size, int64_t *geometry) {
  const int64_t p = 16 / elem_size;
  const int64_t g[] = {kBlock,  kWarpsA,     kLanesA,
                       kLanesB, kPieces,     kPieces * p,
                       kWarpsB * kLanesB * p, kEdgeTile, kEdgeRows};
  for (int i = 0; i < 9; ++i) geometry[i] = g[i];
  return 0;
}

extern "C" int dr_transpose2d(const void *x, void *out, int64_t n, int64_t a,
                              int64_t b, int elem_size, void *stream) {
  if (elem_size != 2 && elem_size != 4) return (int)cudaErrorInvalidValue;
  if (n <= 0 || a <= 0 || b <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return elem_size == 2 ? launch<int16_t>(x, out, n, a, b, s)
                        : launch<int32_t>(x, out, n, a, b, s);
}
