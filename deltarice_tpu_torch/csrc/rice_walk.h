/* The codeword walk that the decode kernels share (unpack.cu for B2,
 * split_decode.cu for B9): a cursor stepped through the codewords that
 * start in a run of words, phase 0's record of where it first starts a
 * codeword in each word, and the join of a walk from another entry phase
 * with that record.
 *
 * A decode is a function of the bit it starts at, so two walks through the
 * same words that start a codeword at the same bit agree from there on. A
 * codeword is at most 25 bits, so every word of a run holds a codeword
 * start of every walk that crosses it, and a walk from entry phase e
 * (0..24) usually meets phase 0's walk within a few codewords.
 */
#ifndef DR_RICE_WALK_H
#define DR_RICE_WALK_H

#include <stdint.h>

#include "rice_decode.h"

namespace dr {

/* Walks the codewords that start in bits [b, lim) of a run of words,
 * b < 32: each is handed to visit(value, its bit, the next codeword's bit),
 * which returns false to stop the walk; returns the exit bit (>= lim,
 * < lim + 25) or, after a stop, the stopping codeword's bit (< lim).
 * load(i) returns word i of the run; (w0, w1, w2) are words 0..2. The
 * window holds the words at and after the cursor's. A codeword is shorter
 * than a word, so the cursor advances by at most one word per codeword and
 * the load of w2 is issued a codeword before it is read. */
template <class Load, class Visit>
__device__ __forceinline__ int walk_words(const Load &load, int b, int lim,
                                          int k, uint32_t w0, uint32_t w1,
                                          uint32_t w2, Visit &visit) {
  int cur = 0;
  while (b < lim) {
    int len;
    const uint32_t u = rice_decode(w0, w1, (unsigned)(b & 31), k, &len);
    if (!visit(unzigzag(u), b, b + len)) break;
    b += len;
    if ((b >> 5) != cur) {
      ++cur;
      w0 = w1;
      w1 = w2;
      w2 = load(cur + 2);
    }
  }
  return b;
}

/* What a walk through a run leaves: the exit phase into the next run, the
 * codewords that started in the run and their wrapping sum. */
struct Walked {
  uint32_t exit, count, sum;
};

/* Visitor of phase 0's walk: counts and sums its codewords and records, for
 * each word j > 0 of the run that it starts a codeword in below lim, its
 * first start there at rec[j * stride]: the bit in the word (5 bits), the
 * codewords before it (11 bits: a run holds at most 1024 codewords) and
 * their wrapping sum (16 bits). */
struct FirstStarts {
  uint32_t *rec;
  int stride, lim;
  uint32_t count, sum;

  __device__ bool operator()(int32_t v, int at, int next) {
    ++count;
    sum += (uint32_t)v;
    if ((next >> 5) != (at >> 5) && next < lim)
      rec[(next >> 5) * stride] =
          ((sum & 0xFFFFu) << 16) | (count << 5) | (uint32_t)(next & 31);
    return true;
  }
};

/* Visitor of a walk from another entry phase through the same run: counts
 * and sums its codewords until it first starts a word at the bit phase 0's
 * walk did, then takes phase 0's remainder (total minus what came before
 * that start) and stops. */
struct JoinFirstStarts {
  const uint32_t *rec;
  int stride, lim;
  Walked phase0;
  uint32_t count, sum;

  __device__ bool operator()(int32_t v, int at, int next) {
    ++count;
    sum += (uint32_t)v;
    if ((next >> 5) != (at >> 5) && next < lim) {
      const uint32_t r = rec[(next >> 5) * stride];
      if ((r & 31u) == (uint32_t)(next & 31)) {
        count += phase0.count - ((r >> 5) & 0x7FFu);
        sum += phase0.sum - (r >> 16);
        return false;
      }
    }
    return true;
  }
};

/* Phase 0's walk through a run of lim bits, recording its first starts. */
template <class Load>
__device__ __forceinline__ Walked walk_phase0(const Load &load, int lim,
                                              int k, uint32_t w0, uint32_t w1,
                                              uint32_t w2, uint32_t *rec,
                                              int stride) {
  FirstStarts v{rec, stride, lim, 0u, 0u};
  const int b = walk_words(load, 0, lim, k, w0, w1, w2, v);
  return {(uint32_t)(b - lim), v.count, v.sum};
}

/* The walk from entry phase e through the same run, joined with phase 0's
 * (whose totals are p0 and whose first starts are at rec). */
template <class Load>
__device__ __forceinline__ Walked walk_joined(const Load &load, int e,
                                              int lim, int k, uint32_t w0,
                                              uint32_t w1, uint32_t w2,
                                              const uint32_t *rec, int stride,
                                              Walked p0) {
  JoinFirstStarts v{rec, stride, lim, p0, 0u, 0u};
  const int b = walk_words(load, e, lim, k, w0, w1, w2, v);
  return {b < lim ? p0.exit : (uint32_t)(b - lim), v.count, v.sum};
}

}  // namespace dr

#endif /* DR_RICE_WALK_H */
