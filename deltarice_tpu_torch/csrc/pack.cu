/* B1: fused delta + zigzag + Rice code + MSB-first bit pack, rate 1.
 *
 * Replaces deltarice_tpu/ops/pack_pallas.py::_pack_kernel (driven by
 * _encode_kernel_program and pack_encode_pallas_bits). The TPU kernel emits
 * one staging slot per sample and leaves the dense stream to a butterfly
 * concentration (_conc_kernel), because a TPU vector store cannot go to a
 * per-lane address. Here a thread stores each completed word at its final
 * row, so there is no staging and no placement pass.
 *
 * One thread encodes one segment serially with a 64-bit accumulator, as
 * the reference's bit writer does: a codeword is at most 25 bits, so each
 * sample completes at most one 32-bit word. Word n of segment s goes to
 * words_t[n * nseg + s] only while n < cap (the caller's output width);
 * nwords and nbits stay exact, so the caller sees which rows overflowed the
 * cap and re-encodes them at the full bound. The tail word keeps its low
 * bits zero; rows past nwords stay as the caller zeroed them.
 *
 * Bound: the serial dependency through the accumulator, and occupancy —
 * 2048 segments are 2048 threads, 64 warps for 132 SMs. Input reads are
 * coalesced (xt is sample-major: neighbouring threads read neighbouring
 * int16s); each thread loads its next kGroup samples before encoding them
 * so their latency overlaps. Word stores of a warp fall in a few
 * neighbouring rows. Filling the card (several threads per segment, as the
 * split encode does) is later work.
 */
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kBlock = 128;
constexpr int kGroup = 8;  // samples loaded ahead per thread
constexpr int kEscapeQ = 8;
constexpr int kEscapeLen = 25;

__global__ void pack_kernel(const int16_t *__restrict__ xt,
                            const int32_t *__restrict__ nvalid,
                            const int32_t *__restrict__ prev0,
                            uint32_t *__restrict__ words_t,
                            int32_t *__restrict__ nwords,
                            int32_t *__restrict__ nbits, int64_t length,
                            int64_t nseg, int64_t cap, int k, int diff) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  int64_t nv = nvalid[s];
  if (nv > length) nv = length;
  int32_t prev = prev0 ? (int32_t)(int16_t)prev0[s] : 0;
  const uint32_t kmask = (1u << k) - 1u;
  uint64_t acc = 0;   // pending bits, top-aligned
  int pos = 0;        // pending bit count, < 32 between samples
  int64_t n = 0;      // completed words
  for (int64_t i0 = 0; i0 < nv; i0 += kGroup) {
    int16_t xs[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      xs[j] = i0 + j < nv ? xt[(i0 + j) * nseg + s] : (int16_t)0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (i0 + j >= nv) continue;
      const int32_t cur = xs[j];
      const int32_t d = diff ? (int32_t)(int16_t)(cur - prev) : cur;
      prev = cur;
      const uint32_t u = ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
      const uint32_t q = u >> k;
      uint32_t val;
      int len;
      if (q >= kEscapeQ) {
        val = (1u << 16) | u;
        len = kEscapeLen;
      } else {
        val = (1u << k) | (u & kmask);
        len = (int)q + 1 + k;
      }
      acc |= (uint64_t)val << (64 - pos - len);
      pos += len;
      if (pos >= 32) {
        if (n < cap) words_t[n * nseg + s] = (uint32_t)(acc >> 32);
        ++n;
        acc <<= 32;
        pos -= 32;
      }
    }
  }
  nbits[s] = (int32_t)(n * 32 + pos);
  if (pos > 0) {
    if (n < cap) words_t[n * nseg + s] = (uint32_t)(acc >> 32);
    ++n;
  }
  nwords[s] = (int32_t)n;
}

}  // namespace

extern "C" int dr_pack_encode(const int16_t *xt, const int32_t *nvalid,
                              const int32_t *prev0, int32_t *words_t,
                              int32_t *nwords, int32_t *nbits, int64_t length,
                              int64_t nseg, int64_t cap, int k, int diff,
                              void *stream) {
  if (nseg <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((nseg + kBlock - 1) / kBlock);
  pack_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      xt, nvalid, prev0, (uint32_t *)words_t, nwords, nbits, length, nseg,
      cap, k, diff);
  return (int)cudaGetLastError();
}
