/* B9: speculative split decode, one thread per (segment, part) sub-block.
 *
 * Replaces deltarice_tpu/ops/split_decode.py::_split_kernel (driven by
 * _split_kernel_program and unpack_decode_split). A segment's word stream
 * is cut into `parts` uniform word ranges of `wsub` words; sub-block p owns
 * words [p*wsub, p*wsub + wv) (wv <= wsub, 0 past the stream) and starts
 * decoding `halo` words early at bit phase 0, riding Rice's
 * self-synchronisation. Sub-block 0 knows its true phase, so its cursor is
 * reset to 0 on entering its first owned word. The thread records its
 * cursor phase on entering its first owned word (ent) and on entering the
 * word past its last (ext); the caller's junction check ent[p] ==
 * ext[p-1] proves the speculation exact, or flags the segment for an exact
 * re-decode through B2.
 *
 * The walk is word-synchronous, as on the TPU: at word t the thread decodes
 * every codeword that starts in it (all of them, at any rate) from the
 * window (w[t], w[t+1]) with the same decode as B2 (rice_decode.h). Inside
 * the owned window it counts, delta-accumulates (wrapping int16) and
 * stores sample n at local[row, n] while n < lw; outside it only advances
 * the cursor. Words outside [0, W) read as zero. Trailing zero-fill bits
 * decode as phantom escape codewords in a segment's last nonempty
 * sub-block; they are counted and stored like any other, and the caller's
 * count-bounded merge clips them.
 *
 * The TPU kernel writes a packed staging plane (disp << 16 | sample) per
 * (word, codeword slot) and compacts it with B7's tiled butterfly, because
 * a vector store cannot go to a per-lane address. Here the thread stores
 * each sample at its local index, so there is no staging and no B7.
 *
 * Layout: words_t is (W, nseg) word-major and thread tid takes segment
 * tid % nseg of part tid / nseg, so the 32 threads of a warp read 32
 * neighbouring words at every step. Outputs are indexed by row =
 * segment * parts + part, as the TPU kernel's: local (rows, lw) int16 and
 * meta (4, rows) int32 = entry phase, exit phase, local count, final delta
 * state.
 *
 * Bound: the serial chain cursor -> window -> clz -> length -> cursor of a
 * one-thread-per-segment decode, over parts times more threads of parts
 * times fewer words
 * (NOPTREX 256 x 500000 at P=32: 8192 threads of ~2000 words instead of
 * 256 threads of ~62,500).
 */
#include <cuda_runtime.h>

#include "kernels.h"
#include "rice_decode.h"

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ uint32_t word_at(const uint32_t *__restrict__ w,
                                            int64_t g, int64_t nw,
                                            int64_t nseg, int64_t s) {
  return (g >= 0 && g < nw) ? w[g * nseg + s] : 0u;
}

__global__ void split_decode_kernel(const uint32_t *__restrict__ words_t,
                                    const int32_t *__restrict__ wv,
                                    int16_t *__restrict__ local,
                                    int32_t *__restrict__ meta, int64_t nw,
                                    int64_t nseg, int64_t parts, int64_t wsub,
                                    int64_t halo, int64_t lw, int k,
                                    int delta) {
  const int64_t rows = nseg * parts;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= rows) return;
  const int64_t p = tid / nseg;
  const int64_t s = tid - p * nseg;
  const int64_t row = s * parts + p;
  const int64_t g0 = p * wsub - halo;  // global index of window word 0
  const int64_t hw = halo + wv[row];   // first window word not owned
  int16_t *out = local + row * lw;
  unsigned pos = 0;  // cursor bit within word t
  int32_t n = 0, ent = 0, ext = 0;
  int16_t acc = 0;
  uint32_t w0 = word_at(words_t, g0, nw, nseg, s);
  uint32_t w1 = word_at(words_t, g0 + 1, nw, nseg, s);
  for (int64_t t = 0;; ++t) {
    if (t == halo) {
      if (p == 0) pos = 0;
      ent = (int32_t)pos;
    }
    if (t == hw) {
      ext = (int32_t)pos;
      break;
    }
    const bool rec = t >= halo;
    while (pos < 32) {
      int len;
      const uint32_t u = dr::rice_decode(w0, w1, pos, k, &len);
      if (rec) {
        const int32_t x = dr::unzigzag(u);
        int16_t v;
        if (delta) {
          acc = (int16_t)(acc + x);
          v = acc;
        } else {
          v = (int16_t)x;
        }
        if (n < lw) out[n] = v;
        ++n;
      }
      pos += (unsigned)len;
    }
    pos -= 32;
    w0 = w1;
    w1 = word_at(words_t, g0 + t + 2, nw, nseg, s);
  }
  meta[row] = ent;
  meta[rows + row] = ext;
  meta[2 * rows + row] = n;
  meta[3 * rows + row] = acc;
}

}  // namespace

extern "C" int dr_split_decode(const int32_t *words_t, const int32_t *wv,
                               int16_t *local, int32_t *meta, int64_t w,
                               int64_t nseg, int64_t parts, int64_t wsub,
                               int64_t halo, int64_t lw, int k, int delta,
                               void *stream) {
  const int64_t rows = nseg * parts;
  if (rows <= 0) return (int)cudaSuccess;
  if (w <= 0 || wsub < 0 || halo < 0 || lw < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  split_decode_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words_t, wv, local, meta, w, nseg, parts, wsub, halo,
      lw, k, delta);
  return (int)cudaGetLastError();
}
