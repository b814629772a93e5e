/* B2: exact Rice decode with the fused delta inverse.
 *
 * Replaces deltarice_tpu/ops/unpack_pallas.py::_unpack_kernel and
 * _decode_one (driven by _kernel_program and unpack_decode_pallas). The TPU
 * kernel walks words, decodes up to J codewords per word into statically
 * addressed staging slots, and needs a butterfly concentration
 * (_conc_kernel) to compact the slots into samples, because a TPU vector
 * store cannot go to a per-lane address. Here a thread stores sample i at
 * its final row, so there is no staging, no compaction and no reduced
 * service rate: the decode is exact for any stream.
 *
 * One thread decodes one segment with a 64-bit bit cursor. The codeword at
 * the cursor is read from the 32-bit window of words (w[t], w[t+1]) by
 * dr::rice_decode (rice_decode.h, shared with B9's split_decode.cu). The cursor
 * is clamped at 32 * (W - 1), as the reference's scan decoder
 * (ops/pack_xla.py::unpack_bits) does, so no read leaves the segment's
 * column; samples past a short segment's end are garbage by contract. A
 * codeword is at most 25 bits, so the window advances by at most one word
 * per codeword: the thread keeps (w[t], w[t+1], w[t+2]) in registers and
 * loads w[t+3] when it advances, so the load it waits on was issued a
 * codeword earlier.
 *
 * Bound: the serial dependency cursor -> window -> clz -> length -> cursor,
 * and occupancy (one thread per segment: 2048 segments are 64 warps for 132
 * SMs). Word reads of a warp are coalesced rows of words_t (word-major);
 * sample stores are coalesced rows of out_t (sample-major).
 */
#include <cuda_runtime.h>

#include "kernels.h"
#include "rice_decode.h"

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ uint32_t load_word(const uint32_t *__restrict__ w,
                                              int64_t t, int64_t nw,
                                              int64_t nseg, int64_t s) {
  return t < nw ? w[t * nseg + s] : 0u;
}

__global__ void unpack_kernel(const uint32_t *__restrict__ words_t,
                              int16_t *__restrict__ out_t, int64_t nw,
                              int64_t nseg, int64_t n_samples, int k,
                              int delta) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const int64_t maxbit = 32 * (nw - 1);
  int64_t bit = 0;
  int64_t t = 0;  // word holding the cursor: w0 = w[t], w1 = w[t+1], w2 = w[t+2]
  uint32_t w0 = load_word(words_t, 0, nw, nseg, s);
  uint32_t w1 = load_word(words_t, 1, nw, nseg, s);
  uint32_t w2 = load_word(words_t, 2, nw, nseg, s);
  int32_t run = 0;
  for (int64_t i = 0; i < n_samples; ++i) {
    int len;
    const uint32_t u = dr::rice_decode(w0, w1, (unsigned)(bit & 31), k, &len);
    const int32_t v = dr::unzigzag(u);
    if (delta) {
      run = (int16_t)(run + v);
      out_t[i * nseg + s] = (int16_t)run;
    } else {
      out_t[i * nseg + s] = (int16_t)v;
    }
    bit += len;
    if (bit > maxbit) bit = maxbit;
    if ((bit >> 5) != t) {  // advanced by exactly one word
      ++t;
      w0 = w1;
      w1 = w2;
      w2 = load_word(words_t, t + 2, nw, nseg, s);
    }
  }
}

}  // namespace

extern "C" int dr_unpack_decode(const int32_t *words_t, int16_t *out_t,
                                int64_t w, int64_t nseg, int64_t n_samples,
                                int k, int delta, void *stream) {
  if (nseg <= 0 || n_samples <= 0) return (int)cudaSuccess;
  if (w <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((nseg + kBlock - 1) / kBlock);
  unpack_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words_t, out_t, w, nseg, n_samples, k, delta);
  return (int)cudaGetLastError();
}
