/* B7 and B8: concentration in the TPU decode kernels' tiled staging layout.
 *
 * The layout: a plane of shape (blocks, R * sb, lanes) holds, at row
 * slot * sb + s and lane l of block b, slot `slot` of segment
 * (b, s * lanes + l). Every (b, s, l) is an independent row of R slots.
 * Seen per block, the plane is (R, C) with C = sb * lanes columns: the C
 * elements of one slot are contiguous, and column c is segment c.
 *
 * B7 replaces deltarice_tpu/ops/concentrate_pallas.py::_tconc_low_kernel
 * and _tconc_high_kernel (driven by concentrate_tiled): one packed int32
 * leader disp << 16 | halfword (dead INT32_MIN, disp < 2^15) with an
 * optional int16 follower (the low halfword of a 32-bit payload), or one
 * sign-biased plane ((disp << 16) | halfword) ^ 2^31 (disp < 2^16, dead
 * INT32_MIN). Output is int16 samples (the halfword) or uint32 words
 * (leader halfword << 16 | follower halfword; the halfword zero-extended
 * without a follower).
 *
 * B8 replaces _tvd_low_kernel, _tvd_mid_kernel and _tvd_high_kernel
 * (driven by concentrate_tiled_vd): an int16 payload plane and an int32
 * displacement plane (>= 0 live, negative dead), any displacement.
 *
 * On the TPU both are Nassimi-Sahni butterflies whose passes are sublane
 * shifts by (1 << b) * sb rows, in up to three VMEM levels. Here each live
 * slot t of a column lands at slot t - disp of the same column;
 * destinations are distinct and increase with t. Destinations outside
 * [0, slots out) are dropped, and the biased plane's dead marker, which is
 * also a live 0 at displacement 0, is skipped for the reason given in
 * concentrate_wide.cu (the zero fill gives the same 0).
 *
 * Bound: device-memory bandwidth, each plane read once and the output
 * written once. What stands between a scatter and it, and what the design
 * does:
 *  - Scattered stores. A slot's C elements are neighbours in memory, but
 *    each column has its own displacement, so the stores of one slot go to
 *    C different output rows: each a 2- or 4-byte piece of its own sector,
 *    finished by stores of other slots much later (the scatter this file
 *    held before took 1.34 ms at the nEDM bucket, 8x its bound). Columns
 *    drift apart by up to ~20,000 rows (NOPTREX staging), too far for a
 *    window of output rows in shared memory; a window that follows a group
 *    of columns, and a thread that walks its own columns and stores a
 *    sector of each at a time, both measured slower (PERF.md). So the
 *    work goes through a segment-major intermediate (blocks, C, stride):
 *    a memset of it gives the zeros of slots nothing reaches;
 *    pass 1 (walk_kernel): a warp stages 128 slots x 32 columns in shared
 *    memory and walks them column by column, its 32 lanes 32 consecutive
 *    slots. Their destinations are consecutive (up to gaps), so a store
 *    instruction writes one run of a column, and a column's four runs go
 *    out back to back: a sector is finished by the next instruction;
 *    pass 2 (untile_kernel): 64 x 64 tiles of the intermediate through
 *    shared memory into the output, 16 bytes a thread both ways.
 *  - Coordinates. A warp owns 32 fixed columns and a span of 2^sshift
 *    slots, given by its index with shifts and masks; offsets are one
 *    multiply-add in 32 bits inside a block, off a 64-bit block base: no
 *    division or modulo by a runtime value.
 *  - Loads. 16-byte pieces (4 leaders or displacements, 8 values or
 *    followers) by cp.async, a warp's whole stage in flight at once,
 *    bypassing L1 (read once).
 * chip_smoke.py times all-dead, all-at-displacement-0 and real staging
 * inputs and the memset and passes apart; ops/concentrate_tiled_model.py
 * walks the same decomposition in plain torch and counts its stores.
 */
#include <cuda_runtime.h>

#include <climits>
#include <cstring>
#include <type_traits>

#include "kernels.h"

namespace {

constexpr int kWalkBlock = 64;  // pass 1: threads per CTA (2 warps: the
                                // stage of B8 is 28 KB a warp)
constexpr int kWalkWarps = kWalkBlock / 32;
constexpr int kRows = 128;      // pass 1: slots a warp stages at a time
// staged row pitches in elements: 16-byte aligned rows, and a column read
// down 32 rows meets each bank at most four times
constexpr int kWherePitch = 36;  // int32 leaders or displacements
constexpr int kOtherPitch = 40;  // int16 followers or values
constexpr int kBlock = 256;     // pass 2: threads per CTA
constexpr int kTile = 64;       // pass 2: tile of slots x columns
// pass 1's spans halve from 2048 slots down to kRows until the grid has
// this many warps
constexpr int64_t kWantWarps = 4096;

// what the kernel reads and writes
enum Kind {
  kPacked16 = 0,     // B7 packed leader -> int16
  kBiased16 = 1,     // B7 biased leader -> int16
  kPackedHalf = 2,   // B7 packed leader -> u32 halfword
  kBiasedHalf = 3,   // B7 biased leader -> u32 halfword
  kPackedFollow = 4, // B7 packed leader + follower -> u32
  kValueDisp = 5,    // B8 values + displacements -> int16
};

template <int K>
using Out = std::conditional_t<K == kPacked16 || K == kBiased16 ||
                                   K == kValueDisp,
                               int16_t, int32_t>;
// besides the plane that says where a slot goes (leader or displacements):
// an int16 follower or values
template <int K>
constexpr bool kHasOther = K == kPackedFollow || K == kValueDisp;

template <int K>
__host__ __device__ constexpr int warp_smem() {  // bytes a warp stages in
  return kRows * kWherePitch * 4 +
         (kHasOther<K> ? kRows * kOtherPitch * 2 : 0);
}

/* Elements from one intermediate row (a column) to the next: slots_out
 * padded to an odd number of tiles, so that the rows of neighbouring
 * columns do not fall on the same memory partition. */
inline int work_stride(int slots_out) {
  const int tiles = (slots_out + kTile - 1) / kTile;
  return (tiles | 1) * kTile;
}

/* Copies 16 bytes from device to shared memory without registers, in
 * flight until cp_async_wait. */
__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

/* Stage slots [t0, t0 + kRows) x columns [c0, c0 + 32) of plane p (a
 * block's (R, cols) view) into tile (row pitch kPitch elements), up to
 * t_end and cols; what lies past them is left as it was and never read.
 * kWide: 16-byte pieces by cp.async, in flight until cp_async_wait (cols a
 * multiple of 8, p 16-byte aligned); else one element a lane, lane =
 * column. */
template <typename E, int kPitch, bool kWide>
__device__ __forceinline__ void stage(const E *__restrict__ p, E *tile,
                                      int t0, int t_end, int c0, int cols,
                                      int lane) {
  if constexpr (kWide) {
    constexpr int kPer = 16 / (int)sizeof(E);  // elements per piece
    constexpr int kPR = 32 / kPer;             // pieces per row
#pragma unroll 8
    for (int i = lane; i < kRows * kPR; i += 32) {
      const int row = i / kPR, q = (i % kPR) * kPer;
      if (t0 + row < t_end && c0 + q < cols)
        cp_async16(tile + row * kPitch + q, p + (t0 + row) * cols + c0 + q);
    }
  } else {
    const int c = c0 + lane;
    if (c < cols)
#pragma unroll 8
      for (int row = 0; row < kRows && t0 + row < t_end; ++row)
        tile[row * kPitch + lane] = __ldcs(p + (t0 + row) * cols + c);
  }
}

/* Pass 1. Warp w of the grid (blockIdx.z: the block of the planes) owns
 * columns [32 * (w & (2^gshift - 1)), +32) and slots [(w >> gshift) <<
 * sshift, +2^sshift). It stages kRows slots of its columns at a time and
 * walks them column by column, lane = slot: a column's kRows / 32 runs go
 * out back to back, so a sector two runs share is finished at once, and
 * every kept slot lands at work[c * stride + dest]. */
template <int kKind, bool kWide>
__global__ void __launch_bounds__(kWalkBlock)
    walk_kernel(const int32_t *__restrict__ where_,
                const int16_t *__restrict__ other_, void *__restrict__ work_,
                int slots_in, int cols, int slots_out, int stride,
                int gshift, int ngroups, int sshift) {
  using O = Out<kKind>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int w = blockIdx.x * kWalkWarps + wi;
  const int group = w & ((1 << gshift) - 1);
  const int64_t t_first = (int64_t)(w >> gshift) << sshift;
  if (group >= ngroups || t_first >= slots_in) return;  // whole warps
  const int t_begin = (int)t_first;
  const int t_end = min(t_begin + (1 << sshift), slots_in);
  const int c0 = group * 32;
  const int64_t plane = (int64_t)blockIdx.z * slots_in * cols;
  const int32_t *wp = where_ + plane;
  const int16_t *op = kHasOther<kKind> ? other_ + plane : nullptr;
  O *work = static_cast<O *>(work_) + (int64_t)blockIdx.z * cols * stride;
  int32_t *wt = reinterpret_cast<int32_t *>(smem + wi * warp_smem<kKind>());
  int16_t *ot = reinterpret_cast<int16_t *>(
      smem + wi * warp_smem<kKind>() + kRows * kWherePitch * 4);
  const int jn = min(32, cols - c0);

  for (int t0 = t_begin; t0 < t_end; t0 += kRows) {
    stage<int32_t, kWherePitch, kWide>(wp, wt, t0, t_end, c0, cols, lane);
    if constexpr (kHasOther<kKind>)
      stage<int16_t, kOtherPitch, kWide>(op, ot, t0, t_end, c0, cols, lane);
    if constexpr (kWide) cp_async_wait();
    __syncwarp();
    for (int j = 0; j < jn; ++j) {
#pragma unroll
      for (int sub = 0; sub < kRows / 32; ++sub) {
        const int r = sub * 32 + lane, t = t0 + r;
        if (t >= t_end) break;
        const int32_t x = wt[r * kWherePitch + j];
        bool live;
        int d;
        O v;
        if constexpr (kKind == kValueDisp) {
          live = x >= 0;
          d = t - x;
          v = ot[r * kOtherPitch + j];
        } else {
          constexpr bool kBias = kKind == kBiased16 || kKind == kBiasedHalf;
          // dead (or, biased, a live 0 at displacement 0)
          live = x != INT32_MIN;
          const uint32_t q = (uint32_t)x ^ (kBias ? 0x80000000u : 0u);
          d = t - (int)(q >> 16);
          const uint32_t half = q & 0xFFFFu;
          if constexpr (kKind == kPacked16 || kKind == kBiased16)
            v = (O)(int16_t)(uint16_t)half;
          else if constexpr (kKind == kPackedFollow)
            v = (O)((half << 16) |
                    (uint32_t)(uint16_t)ot[r * kOtherPitch + j]);
          else
            v = (O)half;
        }
        if (live && (unsigned)d < (unsigned)slots_out)
          work[(c0 + j) * stride + d] = v;
      }
    }
    __syncwarp();
  }
}

/* Pass 2. One 64 x 64 tile: intermediate rows (columns) [c0, +64), slots
 * [d0, +64) into out. kWide: 16-byte pieces both ways (cols a multiple of
 * 64, out 16-byte aligned), every load issued before the first is used;
 * else one element at a time, masked at the ragged column edge. */
template <typename O, bool kWide>
__global__ void __launch_bounds__(kBlock)
    untile_kernel(const O *__restrict__ work, O *__restrict__ out, int cols,
                  int slots_out, int stride) {
  constexpr int kP = 16 / (int)sizeof(O);    // elements per 16-byte piece
  constexpr int kPR = kTile / kP;            // pieces per tile row
  constexpr int kN = kTile * kPR / kBlock;   // pieces per thread
  // [slot][column], the 16-byte pieces of a row permuted by the row's
  // piece index, so that a piece's column written down kP rows and a row
  // read across meet no bank twice
  __shared__ __align__(16) O tile[kTile][kTile];
  auto at = [](int row, int col) {
    return ((col / kP) ^ ((row / kP) & (kPR - 1))) * kP + (col & (kP - 1));
  };
  const int d0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  work += (int64_t)blockIdx.z * cols * stride;
  out += (int64_t)blockIdx.z * slots_out * cols;
  if constexpr (kWide) {
    uint4 v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * kBlock;
      v[k] = __ldcs(reinterpret_cast<const uint4 *>(
          work + (c0 + i / kPR) * stride + d0 + (i % kPR) * kP));
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * kBlock;
      const int r = i / kPR, s = (i % kPR) * kP;
      O e[kP];
      memcpy(e, &v[k], 16);
#pragma unroll
      for (int q = 0; q < kP; ++q) tile[s + q][at(s + q, r)] = e[q];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * kBlock;
      const int r = i / kPR, s = (i % kPR) * kP;
      if (d0 + r < slots_out)
        *reinterpret_cast<uint4 *>(out + (d0 + r) * cols + c0 + s) =
            *reinterpret_cast<const uint4 *>(&tile[r][at(r, s)]);
    }
  } else {
    const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
    constexpr int kRows = kBlock / kTile;
    for (int r = ty; r < kTile; r += kRows)  // d0 + tx < stride
      tile[tx][at(tx, r)] = c0 + r < cols ? work[(c0 + r) * stride + d0 + tx]
                                          : O(0);
    __syncthreads();
    for (int r = ty; r < kTile; r += kRows) {
      const int d = d0 + r, c = c0 + tx;
      if (d < slots_out && c < cols) out[d * cols + c] = tile[r][at(r, tx)];
    }
  }
}

bool aligned16(const void *p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

/* The zero fill, pass 1 and pass 2 on stream s. */
template <int kKind>
int launch(const int32_t *where, const int16_t *other, void *out,
           void *work, int64_t blocks, int slots_in, int cols, int slots_out,
           cudaStream_t s) {
  using O = Out<kKind>;
  // 16-byte loads where a slot's columns split into 16-byte pieces
  const bool wide = cols % 8 == 0 && aligned16(where) && aligned16(other);
  const int stride = work_stride(slots_out);
  cudaError_t rc = cudaMemsetAsync(
      work, 0, (size_t)blocks * cols * stride * sizeof(O), s);
  if (rc != cudaSuccess) return (int)rc;
  const int ngroups = (cols + 31) / 32;
  int gshift = 0;
  while ((1 << gshift) < ngroups) ++gshift;
  int sshift = 11;
  while ((1 << sshift) > kRows &&
         (((int64_t)slots_in >> sshift) << gshift) * blocks < kWantWarps)
    --sshift;
  const int64_t warps =
      (((int64_t)slots_in + (1 << sshift) - 1) >> sshift) << gshift;
  const dim3 g1((unsigned)((warps + kWalkWarps - 1) / kWalkWarps), 1,
                (unsigned)blocks);
  auto *walk = wide ? walk_kernel<kKind, true> : walk_kernel<kKind, false>;
  constexpr int kSmem = kWalkWarps * warp_smem<kKind>();
  rc = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSmem);
  if (rc != cudaSuccess) return (int)rc;
  walk<<<g1, kWalkBlock, kSmem, s>>>(where, other, work, slots_in, cols,
                                     slots_out, stride, gshift, ngroups,
                                     sshift);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 g2((unsigned)((slots_out + kTile - 1) / kTile),
                (unsigned)((cols + kTile - 1) / kTile), (unsigned)blocks);
  const O *w = static_cast<const O *>(work);
  O *o = static_cast<O *>(out);
  if (cols % kTile == 0 && aligned16(out))
    untile_kernel<O, true><<<g2, kBlock, 0, s>>>(w, o, cols, slots_out,
                                                 stride);
  else
    untile_kernel<O, false><<<g2, kBlock, 0, s>>>(w, o, cols, slots_out,
                                                  stride);
  return (int)cudaGetLastError();
}

/* The checks both entry points share; 0 where the kernels take the
 * planes, else cudaErrorInvalidValue. */
int check(int64_t blocks, int64_t rows_in, int64_t lanes, int64_t rows_out,
          int64_t sb, const void *work) {
  if (sb <= 0 || rows_in % sb || rows_out % sb || blocks > 65535 ||
      work == nullptr || !aligned16(work))
    return (int)cudaErrorInvalidValue;
  const int64_t cols = sb * lanes;
  // 32-bit offsets inside a block, in the planes and the intermediate
  if (rows_in * lanes >= INT32_MAX || rows_out * lanes >= INT32_MAX ||
      (int64_t)work_stride((int)(rows_out / sb)) * cols >= INT32_MAX ||
      (cols + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int dr_concentrate_tiled(const int32_t *lead, const int16_t *follow,
                                    void *out, int64_t blocks, int64_t rows_in,
                                    int64_t lanes, int64_t rows_out,
                                    int64_t sb, int mode, int emit_u32,
                                    void *work, void *stream) {
  if (blocks <= 0 || rows_in <= 0 || lanes <= 0 || rows_out <= 0)
    return (int)cudaSuccess;
  if (mode && follow != nullptr) return (int)cudaErrorInvalidValue;
  const int rc = check(blocks, rows_in, lanes, rows_out, sb, work);
  if (rc) return rc;
  const int slots_in = (int)(rows_in / sb), cols = (int)(sb * lanes);
  const int slots_out = (int)(rows_out / sb);
  cudaStream_t s = (cudaStream_t)stream;
#define DR_TILED(K)                                                      \
  launch<K>(lead, follow, out, work, blocks, slots_in, cols, slots_out, s)
  if (!emit_u32) return mode ? DR_TILED(kBiased16) : DR_TILED(kPacked16);
  if (follow != nullptr) return DR_TILED(kPackedFollow);
  return mode ? DR_TILED(kBiasedHalf) : DR_TILED(kPackedHalf);
#undef DR_TILED
}

extern "C" int dr_concentrate_tiled_vd(const int16_t *values,
                                       const int32_t *disp, int16_t *out,
                                       int64_t blocks, int64_t rows_in,
                                       int64_t lanes, int64_t rows_out,
                                       int64_t sb, void *work,
                                       void *stream) {
  if (blocks <= 0 || rows_in <= 0 || lanes <= 0 || rows_out <= 0)
    return (int)cudaSuccess;
  const int rc = check(blocks, rows_in, lanes, rows_out, sb, work);
  if (rc) return rc;
  return launch<kValueDisp>(disp, values, out, work, blocks,
                            (int)(rows_in / sb), (int)(sb * lanes),
                            (int)(rows_out / sb), (cudaStream_t)stream);
}
