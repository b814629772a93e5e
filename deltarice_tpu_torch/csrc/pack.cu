/* B1: fused delta + zigzag + Rice code + MSB-first bit pack, rate 1,
 * parallel inside each segment.
 *
 * Replaces deltarice_tpu/ops/pack_pallas.py::_pack_kernel (driven by
 * _encode_kernel_program and pack_encode_pallas_bits). The TPU kernel
 * gives each segment one lane with a serial bit accumulator and emits one
 * staging slot per sample for a butterfly concentration (_conc_kernel),
 * because a TPU vector store cannot go to a per-lane address. Here every
 * codeword's bit offset is a prefix sum of the lengths before it, so a
 * segment splits into tiles of kTile samples that encode in parallel:
 *
 *   1. bits: one block per (segment, tile) sums its codeword lengths. The
 *      delta is x[i] - x[i-1] (prev0[s] before sample 0), wrapping int16,
 *      so it needs no chain; samples at or past nvalid[s] take 0 bits.
 *   2. scan: one warp per segment takes the exclusive prefix sum of its
 *      tiles' bits (each tile's first bit) and the segment's nbits and
 *      nwords = ceil(nbits / 32).
 *   3. emit: one block per (segment, tile) recomputes its codewords, scans
 *      their lengths across the block, ORs each codeword into the tile's
 *      words in shared memory, and writes them out: a word it owns whole
 *      with a store, its first and last word (which may share bits with a
 *      neighbouring tile) with atomicOr into the zeroed output. OR
 *      commutes, so the words do not depend on the order.
 *
 * Words at or past cap are dropped while nwords and nbits stay exact, so
 * the caller sees which rows overflowed the cap and re-encodes them at the
 * full bound; words past nwords stay as the caller zeroed them.
 *
 * Bound: memory — each sample is read twice (passes 1 and 3) and each word
 * written once; samples (nseg, length) and words (nseg, cap) are
 * segment-major, so the codec needs no transpose around the kernel.
 */
#include <cuda_runtime.h>
#include <limits.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                       // consecutive samples per thread
constexpr int kTile = kThreads * kPer;        // samples per tile
constexpr int kEscapeQ = 8;
constexpr int kEscapeLen = 25;
constexpr int kTileWords = kTile * kEscapeLen / 32 + 2;  // incl. phase

struct Segment {
  const int16_t *row;
  int64_t nv;
  int32_t prev0;
};

__device__ __forceinline__ Segment segment(const int16_t *x,
                                           const int32_t *nvalid,
                                           const int32_t *prev0, int64_t s,
                                           int64_t length) {
  int64_t nv = nvalid[s];
  nv = nv < 0 ? 0 : (nv > length ? length : nv);
  return {x + s * length, nv, prev0 ? (int32_t)(int16_t)prev0[s] : 0};
}

/* Codeword of sample i: its length (0 past nvalid) and right-aligned bits. */
__device__ __forceinline__ int code(const Segment &g, int64_t i, int k,
                                    int diff, uint32_t *val) {
  if (i >= g.nv) return 0;
  const int32_t cur = g.row[i];
  const int32_t prev = i > 0 ? (int32_t)g.row[i - 1] : g.prev0;
  const int32_t d = diff ? (int32_t)(int16_t)(cur - prev) : cur;
  const uint32_t u = ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
  const uint32_t q = u >> k;
  if (q >= kEscapeQ) {
    *val = (1u << 16) | u;
    return kEscapeLen;
  }
  *val = (1u << k) | (u & ((1u << k) - 1u));
  return (int)q + 1 + k;
}

/* Exclusive block scan of v over kThreads threads; *total gets the sum. */
__device__ __forceinline__ int block_scan(int v, int *total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int ws = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kThreads / 32; d <<= 1) {
      const int n = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      if (lane >= d) ws += n;
    }
    if (lane < kThreads / 32) warp_sums[lane] = ws;  // inclusive
  }
  __syncthreads();
  *total = warp_sums[kThreads / 32 - 1];
  return incl - v + (wid > 0 ? warp_sums[wid - 1] : 0);
}

/* Pass 1: tile_bits[s * ntiles + t]. */
__global__ void bits_kernel(const int16_t *__restrict__ x,
                            const int32_t *__restrict__ nvalid,
                            const int32_t *__restrict__ prev0,
                            int32_t *__restrict__ tile_bits, int64_t length,
                            int64_t ntiles, int k, int diff) {
  const int64_t b = blockIdx.x;
  const Segment g = segment(x, nvalid, prev0, b / ntiles, length);
  const int64_t i0 = (b % ntiles) * kTile;
  int bits = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    uint32_t val;
    bits += code(g, i0 + j * kThreads + threadIdx.x, k, diff, &val);
  }
  int total;
  block_scan(bits, &total);
  if (threadIdx.x == 0) tile_bits[b] = total;
}

/* Pass 2: one warp per segment. */
__global__ void scan_kernel(const int32_t *__restrict__ tile_bits,
                            int32_t *__restrict__ tile_off,
                            int32_t *__restrict__ nwords,
                            int32_t *__restrict__ nbits, int64_t nseg,
                            int64_t ntiles) {
  const int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= nseg) return;
  int32_t carry = 0;
  for (int64_t c = 0; c < ntiles; c += 32) {
    const int64_t t = c + lane;
    const int32_t v = t < ntiles ? tile_bits[s * ntiles + t] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t n = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += n;
    }
    if (t < ntiles) tile_off[s * ntiles + t] = carry + incl - v;
    carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
  }
  if (lane == 0) {
    nbits[s] = carry;
    nwords[s] = (int32_t)(((int64_t)carry + 31) >> 5);
  }
}

/* Pass 3: thread j codes samples i0 + kPer * j .. + kPer - 1, so the block
 * scan of its bits gives each codeword's offset in the tile. */
__global__ void emit_kernel(const int16_t *__restrict__ x,
                            const int32_t *__restrict__ nvalid,
                            const int32_t *__restrict__ prev0,
                            const int32_t *__restrict__ tile_off,
                            uint32_t *__restrict__ words, int64_t length,
                            int64_t ntiles, int64_t cap, int k, int diff) {
  __shared__ uint32_t sw[kTileWords];
  const int64_t b = blockIdx.x;
  const int64_t s = b / ntiles;
  const Segment g = segment(x, nvalid, prev0, s, length);
  const int64_t i0 = (b % ntiles) * kTile + (int64_t)threadIdx.x * kPer;
  for (int j = threadIdx.x; j < kTileWords; j += kThreads) sw[j] = 0u;
  uint32_t val[kPer];
  int len[kPer];
  int bits = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    len[j] = code(g, i0 + j, k, diff, &val[j]);
    bits += len[j];
  }
  int total;
  int off = block_scan(bits, &total);  // also orders the zeroing above
  if (total == 0) return;
  const int64_t start = tile_off[b];
  off += (int)(start & 31);  // bit of the tile's first word
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (len[j] == 0) continue;
    const int wi = off >> 5;
    const uint64_t v = (uint64_t)val[j] << (64 - (off & 31) - len[j]);
    atomicOr(&sw[wi], (uint32_t)(v >> 32));
    if ((uint32_t)v) atomicOr(&sw[wi + 1], (uint32_t)v);
    off += len[j];
  }
  __syncthreads();
  const int nw = (int)(((start & 31) + total + 31) >> 5);
  const int64_t w0 = start >> 5;
  uint32_t *row = words + s * cap;
  for (int j = threadIdx.x; j < nw && w0 + j < cap; j += kThreads) {
    if (j == 0 || j == nw - 1)
      atomicOr(&row[w0 + j], sw[j]);
    else
      row[w0 + j] = sw[j];
  }
}

}  // namespace

extern "C" int64_t dr_pack_scratch_words(int64_t length, int64_t nseg) {
  return 2 * nseg * ((length + kTile - 1) / kTile);
}

extern "C" int dr_pack_encode(const int16_t *x, const int32_t *nvalid,
                              const int32_t *prev0, int32_t *words,
                              int32_t *nwords, int32_t *nbits,
                              int32_t *scratch, int64_t length, int64_t nseg,
                              int64_t cap, int k, int diff, void *stream) {
  if (nseg <= 0) return (int)cudaSuccess;
  if (length < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = (length + kTile - 1) / kTile;
  if (nseg * ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int32_t *tile_bits = scratch, *tile_off = scratch + nseg * ntiles;
  if (ntiles > 0) {
    bits_kernel<<<(unsigned)(nseg * ntiles), kThreads, 0, st>>>(
        x, nvalid, prev0, tile_bits, length, ntiles, k, diff);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t scan_blocks = (nseg * 32 + kThreads - 1) / kThreads;
  scan_kernel<<<(unsigned)scan_blocks, kThreads, 0, st>>>(
      tile_bits, tile_off, nwords, nbits, nseg, ntiles);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ntiles == 0 || cap == 0) return (int)e;
  emit_kernel<<<(unsigned)(nseg * ntiles), kThreads, 0, st>>>(
      x, nvalid, prev0, tile_off, (uint32_t *)words, length, ntiles, cap, k,
      diff);
  return (int)cudaGetLastError();
}
