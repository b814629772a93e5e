/* B9: speculative split decode, one warp per (segment, part) sub-block,
 * parallel inside it.
 *
 * Replaces deltarice_tpu/ops/split_decode.py::_split_kernel (driven by
 * _split_kernel_program and unpack_decode_split). A segment's word stream
 * is cut into `parts` uniform word ranges of `wsub` words; sub-block p owns
 * words [p*wsub, p*wsub + wv) (wv <= wsub, 0 past the stream) and starts
 * decoding `halo` words early at bit phase 0, riding Rice's
 * self-synchronisation. Its window is words [p*wsub - halo, p*wsub + wv)
 * of the segment, zero outside [0, W). Sub-block 0 knows its true phase,
 * so its cursor is reset to 0 on entering its first owned word. The row
 * reports its cursor phase on entering its first owned word (ent) and on
 * entering the word past its last (ext); the caller's junction check
 * ent[p] == ext[p-1] proves the speculation exact, or flags the segment
 * for an exact re-decode through B2. Inside the owned words it counts the
 * codewords that start there (trailing zero fill decodes as phantom escape
 * codewords, counted like any other; the caller's count-bounded merge
 * clips them), delta-accumulates (wrapping int16) and stores sample n at
 * local[row, n] while n < lw; local is zero past the row's count.
 *
 * What the result must equal is the TPU kernel's word-synchronous serial
 * walk (split_decode_plain in ops/split_decode_cuda.py). A thread per row
 * walking ~13 K codewords one after another, with a global load per word,
 * is bound by latency (one warp per scheduler on a quarter of the SMs).
 * Here the window is walked in chunks of kChunk words staged in shared
 * memory with coalesced loads, and each chunk is cut into 32 lane
 * stretches that a warp walks at once, exactly, in three passes (the walk,
 * record and join of rice_walk.h, shared with B2):
 *
 *   A. each lane walks its stretch from phase 0 and records, for each
 *      word, where that walk first starts a codeword in it and the count
 *      and wrapping sum before that start;
 *   B. lane i assumes its entry phase is lane i-1's phase-0 exit (lane 0
 *      takes the chunk's known entry) and walks from it only until it
 *      starts a word at the bit phase 0's walk did, then takes the
 *      recorded remainder. A lane whose true entry differs (its
 *      predecessor's walk did not meet phase 0's inside its stretch) is
 *      walked again from its true entry, lane after lane from the first
 *      such lane, until an exit equals the next lane's assumption. On a
 *      stream that never resynchronises every lane is walked again, to its
 *      end, and the result stays exact;
 *   C. warp prefix sums give each lane its first sample index and running
 *      value, and every lane decodes its stretch from its true entry phase.
 *      A lane's samples form one run of the output; a store per lane would
 *      touch 32 lines per warp instruction, so each round a lane stages
 *      its next kRun samples in shared memory and the warp writes every
 *      lane's run out with consecutive lanes on consecutive samples.
 *
 * The halo is one such range without stores (sub-block 0 skips it). The
 * chunk's exit phase, count and sum carry into the next chunk. Passes A
 * and C are full walks of a stretch (kChunk / 32 words); B is a few
 * codewords per lane. Bound: issue slots of the walks (no global load in
 * the dependent chain), against the bytes of the owned words in and the
 * samples out.
 *
 * Layout: words (nseg, w) segment-major, as the codec holds them; row
 * index = segment * parts + part. Outputs: local (rows, lw) int16 and meta
 * (4, rows) int32 = entry phase, exit phase, local count, final delta
 * state.
 */
#include <cuda_runtime.h>
#include <limits.h>

#include "kernels.h"
#include "rice_walk.h"

namespace {

constexpr int kWarps = 4;           // rows (warps) per block
constexpr int kChunk = 512;         // window words staged per step
constexpr int kMinStretch = 4;      // words per lane stretch, at least
constexpr int kStage = kChunk + 3;  // + the words a stretch's end reads
constexpr int kRun = 32;            // samples a lane stages per round
constexpr int kRunStride = kRun + 2;  // int16s: lanes' runs on other banks
constexpr unsigned kFull = 0xFFFFFFFFu;

/* State at a chunk boundary: entry phase, codewords so far, their
 * wrapping sum. */
struct Carry {
  uint32_t phase, count, sum;
};

__device__ __forceinline__ dr::Walked shfl_walked(const dr::Walked &v,
                                                  int lane) {
  return {__shfl_sync(kFull, v.exit, lane), __shfl_sync(kFull, v.count, lane),
          __shfl_sync(kFull, v.sum, lane)};
}

/* One chunk of len window words, staged at sw[0 .. len + 3), walked from
 * state c by the whole warp, with the records at rec and the rounds of
 * pass C at so; stores samples from local[base + c.count] on (flat index,
 * below stop) when `store`. Passes past kUpTo are skipped (for timing the
 * passes on the card; kUpTo = 4 runs them all). */
template <int kUpTo>
__device__ Carry walk_chunk(const uint32_t *sw, uint32_t *rec, int16_t *so,
                            int len, Carry c, int k, bool store, bool delta,
                            int16_t *local, int64_t base, int64_t stop) {
  const int lane = threadIdx.x & 31;
  const int st = max(kMinStretch, (len + 31) / 32);  // words per stretch
  const int nl = (len + st - 1) / st;                // lanes with words
  const int b0 = lane * st, b1 = min(b0 + st, len);
  const bool live = lane < nl;
  const int lim = 32 * (b1 - b0);
  const uint32_t *ws = sw + b0;
  const auto load = [ws](int i) { return ws[i]; };
  if (kUpTo < 2) {  // what a stopped launch computed feeds meta, so that
    c.sum += sw[lane];  // the compiler keeps it
    return c;
  }
  // A: phase 0 through the stretch, recording its first start per word
  dr::Walked p0{0u, 0u, 0u};
  if (live)
    p0 = dr::walk_phase0(load, lim, k, ws[0], ws[1], ws[2], rec + b0, 1);
  __syncwarp();
  if (kUpTo < 3) {
    c.sum += p0.exit + p0.count + p0.sum + rec[lane];
    return c;
  }
  // B: from the assumed entry, joined with phase 0's walk
  uint32_t a = __shfl_up_sync(kFull, p0.exit, 1);
  if (lane == 0) a = c.phase;
  dr::Walked me = p0;
  if (live && a != 0)
    me = dr::walk_joined(load, (int)a, lim, k, ws[0], ws[1], ws[2], rec + b0,
                         1, p0);
  const uint32_t prev_exit = __shfl_up_sync(kFull, me.exit, 1);
  unsigned bad = __ballot_sync(kFull, live && lane > 0 && prev_exit != a);
  while (bad) {  // warp-uniform: walk lanes again from their true entries
    int i = __ffs(bad) - 1;
    uint32_t e = __shfl_sync(kFull, me.exit, i - 1);
    for (;;) {
      bad &= ~(1u << i);
      const int i0 = i * st, ilim = 32 * (min(i0 + st, len) - i0);
      const uint32_t *iws = sw + i0;
      const auto iload = [iws](int j) { return iws[j]; };
      const dr::Walked ip0 = shfl_walked(p0, i);
      const dr::Walked r =
          e == 0 ? ip0
                 : dr::walk_joined(iload, (int)e, ilim, k, iws[0], iws[1],
                                   iws[2], rec + i0, 1, ip0);
      if (lane == i) {
        a = e;
        me = r;
      }
      e = r.exit;
      if (++i >= nl || e == __shfl_sync(kFull, a, i)) break;
    }
    if (i < nl) bad &= ~(1u << i);  // lane i assumed right after all
  }
  // prefix sums over the lanes: first sample index and running value
  uint32_t n = live ? me.count : 0u, s = live ? me.sum : 0u;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t pn = __shfl_up_sync(kFull, n, d);
    const uint32_t ps = __shfl_up_sync(kFull, s, d);
    if (lane >= d) {
      n += pn;
      s += ps;
    }
  }
  const Carry out{__shfl_sync(kFull, me.exit, nl - 1),
                  c.count + __shfl_sync(kFull, n, 31),
                  c.sum + __shfl_sync(kFull, s, 31)};
  if (kUpTo < 4 || !store) return out;
  // C: decode the stretch from its true entry. Each round a lane stages
  // its next kRun samples in shared memory; the warp then writes each
  // lane's run out with consecutive lanes on consecutive samples.
  int64_t idx = base + c.count + (n - (live ? me.count : 0u));  // flat
  const int64_t end = live ? min(idx + me.count, stop) : idx;
  uint32_t run = c.sum + (s - (live ? me.sum : 0u));
  int b = (int)a;  // cursor bit in the stretch
  int16_t *mine = so + lane * kRunStride;
  const int rounds = (int)__reduce_max_sync(
      kFull, (unsigned)((max(end - idx, (int64_t)0) + kRun - 1) / kRun));
  for (int round = 0; round < rounds; ++round) {
    int got = 0;
    if (idx < end) {
      const int64_t room = min((int64_t)kRun, end - idx);
      const int wi = b >> 5;
      const uint32_t *wr = ws + wi;
      const auto rload = [wr](int i) { return wr[i]; };
      auto put = [&](int32_t v, int, int) {
        if (got == room) return false;  // this codeword opens the next round
        run = delta ? run + (uint32_t)v : (uint32_t)v;
        mine[got++] = (int16_t)run;
        return true;
      };
      b = 32 * wi + dr::walk_words(rload, b & 31, lim - 32 * wi, k, wr[0],
                                   wr[1], wr[2], put);
    }
    __syncwarp();
    for (int from = 0; from < 32; ++from) {
      const int m = __shfl_sync(kFull, got, from);
      const int64_t at = __shfl_sync(kFull, idx, from);
      if (lane < m) local[at + lane] = so[from * kRunStride + lane];
    }
    idx += got;
    __syncwarp();
  }
  return out;
}

/* Stages window words [c0, c0 + kStage) of a row whose window word 0 is
 * segment word g0 into sw, zero outside the segment's [0, w). */
__device__ __forceinline__ void stage(uint32_t *sw,
                                      const uint32_t *__restrict__ seg,
                                      int64_t g0, int64_t c0, int64_t w) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the previous chunk's walks are done with sw
  for (int i = lane; i < kStage; i += 32) {
    const int64_t g = g0 + c0 + i;
    sw[i] = (g >= 0 && g < w) ? __ldg(seg + g) : 0u;
  }
  __syncwarp();
}

template <int kUpTo>
__global__ void __launch_bounds__(kWarps * 32)
    split_decode_kernel(const uint32_t *__restrict__ words,
                        const int32_t *__restrict__ wv,
                        int16_t *__restrict__ local,
                        int32_t *__restrict__ meta,
                        int64_t w, int64_t rows, int64_t parts, int64_t wsub,
                        int64_t halo, int64_t lw, int k, int delta) {
  __shared__ uint32_t s_words[kWarps][kStage];
  __shared__ uint32_t s_rec[kWarps][kChunk];
  __shared__ int16_t s_out[kWarps][32 * kRunStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves
  const int64_t s = row / parts, p = row - s * parts;
  const uint32_t *seg = words + s * w;
  const int64_t g0 = p * wsub - halo;  // segment word of window word 0
  const int64_t hw = halo + wv[row];   // first window word not owned
  uint32_t *sw = s_words[warp], *rec = s_rec[warp];
  int16_t *so = s_out[warp];
  const int64_t base = row * lw, stop = base + lw;
  Carry c{0u, 0u, 0u};
  if (p > 0) {  // the halo: only its exit phase counts
    for (int64_t c0 = 0; c0 < halo; c0 += kChunk) {
      stage(sw, seg, g0, c0, w);
      c = walk_chunk<kUpTo>(sw, rec, so, (int)min((int64_t)kChunk, halo - c0),
                            c, k, false, delta, local, base, stop);
    }
  }
  const uint32_t ent = p > 0 ? c.phase : 0u;
  c = {ent, 0u, kUpTo < 3 ? c.sum : 0u};  // (a stopped launch's fold)
  for (int64_t c0 = halo; c0 < hw; c0 += kChunk) {
    stage(sw, seg, g0, c0, w);
    c = walk_chunk<kUpTo>(sw, rec, so, (int)min((int64_t)kChunk, hw - c0), c,
                          k, true, delta, local, base, stop);
  }
  if (kUpTo == 4) {  // zeros past the row's count
    for (int64_t i = base + min((int64_t)c.count, lw) + lane; i < stop;
         i += 32)
      local[i] = 0;
  }
  if (lane == 0) {
    meta[row] = (int32_t)ent;
    meta[rows + row] = (int32_t)c.phase;
    meta[2 * rows + row] = (int32_t)c.count;
    meta[3 * rows + row] = delta ? (int32_t)(int16_t)(c.sum & 0xFFFFu) : 0;
  }
}

template <int kUpTo>
cudaError_t launch(const int32_t *words, const int32_t *wv, int16_t *local,
                   int32_t *meta, int64_t w, int64_t rows, int64_t parts,
                   int64_t wsub, int64_t halo, int64_t lw, int k, int delta,
                   cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  split_decode_kernel<kUpTo><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const uint32_t *)words, wv, local, meta, w, rows, parts, wsub, halo,
      lw, k, delta);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dr_split_decode(const int32_t *words, const int32_t *wv,
                               int16_t *local, int32_t *meta, int64_t w,
                               int64_t nseg, int64_t parts, int64_t wsub,
                               int64_t halo, int64_t lw, int k, int delta,
                               int passes, void *stream) {
  const int64_t rows = nseg * parts;
  if (rows <= 0) return (int)cudaSuccess;
  if (w <= 0 || wsub < 0 || halo < 0 || lw < 0 || k < 0 || k > 15)
    return (int)cudaErrorInvalidValue;
  if (wsub > INT_MAX / 2 || halo > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (passes) {
    case 1:
      return (int)launch<1>(words, wv, local, meta, w, rows, parts, wsub,
                            halo, lw, k, delta, st);
    case 2:
      return (int)launch<2>(words, wv, local, meta, w, rows, parts, wsub,
                            halo, lw, k, delta, st);
    case 3:
      return (int)launch<3>(words, wv, local, meta, w, rows, parts, wsub,
                            halo, lw, k, delta, st);
    case 4:
      return (int)launch<4>(words, wv, local, meta, w, rows, parts, wsub,
                            halo, lw, k, delta, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
