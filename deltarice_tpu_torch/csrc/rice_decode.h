/* One Rice codeword decode at a bit offset, shared by the decode kernels
 * (unpack.cu for B2, split_decode.cu for B9) so that both read the stream
 * exactly alike.
 *
 * The codeword starting at bit `off` (< 32) of word w0 is read from the
 * 32-bit window (w0, w1) << off; its quotient is min(clz(window), 8), 8
 * marking the 25-bit escape (8 zeros, a 1, the 16-bit value verbatim).
 * The ((w1 >> (31 - off)) >> 1) form needs no branch for off == 0, where a
 * single shift by 32 would be undefined.
 */
#ifndef DR_RICE_DECODE_H
#define DR_RICE_DECODE_H

#include <stdint.h>

namespace dr {

constexpr unsigned kEscapeQ = 8;
constexpr int kEscapeLen = 25;

/* Zigzag value of the codeword at bit `off` of (w0, w1); its length in bits
 * goes to *len. */
__device__ __forceinline__ uint32_t rice_decode(uint32_t w0, uint32_t w1,
                                                unsigned off, int k,
                                                int *len) {
  const uint32_t win = (w0 << off) | ((w1 >> (31u - off)) >> 1);
  unsigned q = __clz(win);  // 32 for a zero window
  if (q >= kEscapeQ) {
    *len = kEscapeLen;
    return (win >> (32 - kEscapeLen)) & 0xFFFFu;
  }
  *len = (int)q + 1 + k;
  return (q << k) | ((win >> (31u - (unsigned)k - q)) & ((1u << k) - 1u));
}

__device__ __forceinline__ int32_t unzigzag(uint32_t u) {
  return (int32_t)((u >> 1) ^ (0u - (u & 1u)));
}

}  // namespace dr

#endif /* DR_RICE_DECODE_H */
