/* B2: exact Rice decode with the fused delta inverse, parallel inside each
 * segment.
 *
 * Replaces deltarice_tpu/ops/unpack_pallas.py::_unpack_kernel and
 * _decode_one (driven by _kernel_program and unpack_decode_pallas). The TPU
 * kernel gives each segment one lane and walks its words in order, staging
 * codewords in statically addressed slots for a butterfly compaction. Here
 * samples are stored at their final index, and the serial chain inside a
 * segment (cursor -> window -> clz -> length -> cursor) is cut into tiles
 * of kTileWords words that decode in parallel, exactly, in a fixed number
 * of passes:
 *
 *   1. tables: a codeword is at most 25 bits, so the first codeword that
 *      starts in a tile starts at bit phase 0..24 of it. For each entry
 *      phase the tile's table holds the exit phase into the next tile, the
 *      number of codewords that start in the tile and the wrapping int16
 *      sum of their values (the walk, record and join of rice_walk.h, which
 *      B9 shares). One thread per (segment, tile) walks phase 0 through the
 *      whole tile and records, for each word, where that walk first starts
 *      a codeword in it and its count and sum before that start. Walks from
 *      the other phases resynchronise with it within a few codewords (a
 *      decode is a function of the start bit), so each walks only until it
 *      first starts a word at the same bit as phase 0 did and then takes
 *      phase 0's remainder: about one full walk per tile instead of 25.
 *   2. resolve: the tables are functions of the entry phase and compose
 *      associatively (phases map, counts add, sums add mod 2^16). Groups
 *      of kGroup tables compose into one table per group, level by level,
 *      until one group spans the segment; then, from each segment's known
 *      start (phase 0, sample 0, value 0), each group's entry state is
 *      walked down through its members to every tile: its entry phase, its
 *      first sample index and the running value before it.
 *   3. decode: one thread per (segment, tile) decodes the tile from its
 *      entry phase and stores sample n at out[s, first + n], packing four
 *      int16s into one 8-byte store where it owns the whole group.
 *   4. tail: the cursor of the serial decode is clamped at 32 * (W - 1), as
 *      the reference's scan decoder (ops/pack_xla.py::unpack_bits) clamps
 *      it, so every sample past the last codeword that starts before the
 *      clamp re-decodes the codeword at the clamp (the pad word) and, with
 *      the delta inverse, keeps accumulating it. One block per segment
 *      fills those samples arithmetically.
 *
 * Bound: not bytes. Pass 1 takes most of the time, and within it the 24
 * short phases cost far more than their few codewords each; what bounds
 * them (divergence at each phase's end, latency) is not measured yet.
 * Passes 2 and 4 are short.
 * Words are read segment-major (row s contiguous), samples written
 * segment-major, so the codec needs no transpose around the kernel.
 */
#include <cuda_runtime.h>
#include <limits.h>

#include "kernels.h"
#include "rice_walk.h"

namespace {

constexpr int kTileWords = 32;               // words per tile
constexpr int kTileBits = 32 * kTileWords;
constexpr int kPhases = 25;                  // entry phases 0..24
constexpr int kGroup = 32;                   // tables composed per group
constexpr int kBlock = 128;
constexpr int kTailBlock = 256;
constexpr int kMaxLevels = 16;

/* A table entry or an entry state is a uint2: x = codeword count (or first
 * sample index), y = (int16 sum or running value) << 16 | phase. */
__device__ __forceinline__ uint2 entry(uint32_t n, uint32_t value,
                                       uint32_t phase) {
  return make_uint2(n, (value << 16) | phase);
}

__device__ __forceinline__ uint32_t load_word(const uint32_t *__restrict__ row,
                                              int64_t i, int64_t w) {
  return i < w ? __ldg(row + i) : 0u;
}

/* Pass 1: tab[(s * ntiles + t) * kPhases + phase], one thread per
 * (segment, tile). rec[j][thread] = phase 0's first start in word j > 0
 * of the tile: its bit in the word (5 bits), the codewords before it (11
 * bits: a tile holds at most 1024) and their wrapping sum (16 bits). Each
 * phase is a loop of its own, so the threads of a warp reconverge after
 * every phase. */
__global__ void tables_kernel(const uint32_t *__restrict__ words,
                              uint2 *__restrict__ tab, int64_t w,
                              int64_t nseg, int64_t ntiles, int k) {
  __shared__ uint32_t rec[kTileWords][kBlock];
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg * ntiles) return;
  const int64_t s = g / ntiles, t = g % ntiles;
  const uint32_t *row = words + s * w;
  const int64_t t0 = t * kTileWords;
  const int lim = (int)min((int64_t)kTileBits, 32 * (w - 1) - 32 * t0);
  uint2 *out = tab + g * kPhases;
  // every phase starts in the tile's first word: its window stays loaded
  const uint32_t a0 = load_word(row, t0, w), a1 = load_word(row, t0 + 1, w),
                 a2 = load_word(row, t0 + 2, w);
  const auto load = [row, t0, w](int i) { return load_word(row, t0 + i, w); };
  uint32_t *mine = &rec[0][threadIdx.x];
  const dr::Walked p0 =
      dr::walk_phase0(load, lim, k, a0, a1, a2, mine, kBlock);
  out[0] = entry(p0.count, p0.sum & 0xFFFFu, p0.exit);
  for (int e = 1; e < kPhases; ++e) {
    const dr::Walked r =
        dr::walk_joined(load, e, lim, k, a0, a1, a2, mine, kBlock, p0);
    out[e] = entry(r.count, r.sum & 0xFFFFu, r.exit);
  }
}

/* Pass 2, up: table of group grp at level l + 1 = its members at level l
 * (n per segment) composed in order, for each entry phase. */
__global__ void compose_kernel(const uint2 *__restrict__ tab,
                               uint2 *__restrict__ up, int64_t nseg,
                               int64_t n, int64_t nup) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg * nup * kPhases) return;
  const uint32_t phase = (uint32_t)(g % kPhases);
  const int64_t sg = g / kPhases;
  const int64_t s = sg / nup, grp = sg % nup;
  const uint2 *base = tab + s * n * kPhases;
  const int64_t j1 = min(grp * kGroup + kGroup, n);
  uint32_t e = phase, count = 0, sum = 0;
  for (int64_t j = grp * kGroup; j < j1; ++j) {
    const uint2 v = base[j * kPhases + e];
    count += v.x;
    sum += v.y >> 16;
    e = v.y & 0xFFu;
  }
  up[g] = entry(count, sum & 0xFFFFu, e);
}

/* Pass 2, down: entry states of the members of group grp (level l, n per
 * segment) from the group's entry state (level l + 1, nup per segment). */
__global__ void resolve_kernel(const uint2 *__restrict__ tab,
                               const uint2 *__restrict__ ent_up,
                               uint2 *__restrict__ ent, int64_t nseg,
                               int64_t n, int64_t nup) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg * nup) return;
  const int64_t s = g / nup, grp = g % nup;
  const uint2 st = ent_up[g];
  uint32_t first = st.x, run = st.y >> 16, e = st.y & 0xFFu;
  const int64_t j1 = min(grp * kGroup + kGroup, n);
  for (int64_t j = grp * kGroup; j < j1; ++j) {
    ent[s * n + j] = entry(first, run, e);
    const uint2 v = tab[(s * n + j) * kPhases + e];
    first += v.x;
    run = (run + (v.y >> 16)) & 0xFFFFu;
    e = v.y & 0xFFu;
  }
}

/* Stores consecutive samples of one thread from flat index gi on (out is
 * 8-byte aligned): a group of four aligned samples that the thread fills
 * whole goes out as one 8-byte store, a partial group (a run's first and
 * last) sample by sample. acc holds the samples [g0, gi) of the group. */
struct SampleWriter {
  int16_t *out;
  int64_t gi, g0;
  uint64_t acc;

  __device__ void store(int64_t end) {
    for (int64_t m = g0; m < end; ++m)
      out[m] = (int16_t)(acc >> (16 * (m & 3)));
  }
  __device__ void put(int16_t v) {
    acc |= (uint64_t)(uint16_t)v << (16 * (gi & 3));
    if ((gi & 3) == 3) {
      if (g0 == gi - 3)
        *reinterpret_cast<uint64_t *>(out + g0) = acc;
      else
        store(gi + 1);
      acc = 0;
      g0 = gi + 1;
    }
    ++gi;
  }
  __device__ void finish() { store(gi); }
};

/* Pass 3: one thread per (segment, tile). */
__global__ void decode_kernel(const uint32_t *__restrict__ words,
                              const uint2 *__restrict__ ent,
                              int16_t *__restrict__ out, int64_t w,
                              int64_t nseg, int64_t ntiles,
                              int64_t n_samples, int k, int delta) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg * ntiles) return;
  const int64_t s = g / ntiles, t = g % ntiles;
  const uint2 st = ent[g];
  const int64_t first = st.x;
  if (first >= n_samples) return;
  const int64_t t0 = t * kTileWords;
  const int lim = (int)min((int64_t)kTileBits, 32 * (w - 1) - 32 * t0);
  const int64_t stop = s * n_samples + n_samples;
  uint32_t run = st.y >> 16;
  SampleWriter wr{out, s * n_samples + first, s * n_samples + first, 0};
  const uint32_t *row = words + s * w;
  const auto load = [row, t0, w](int i) { return load_word(row, t0 + i, w); };
  auto store = [&](int32_t v, int, int) {
    run = delta ? run + (uint32_t)v : (uint32_t)v;
    wr.put((int16_t)run);
    return wr.gi < stop;
  };
  dr::walk_words(load, (int)(st.y & 0xFFu), lim, k, load_word(row, t0, w),
                 load_word(row, t0 + 1, w), load_word(row, t0 + 2, w), store);
  wr.finish();
}

/* Pass 4: one block per segment fills [count of codewords before the
 * clamp, n_samples) with the codeword at the clamp. */
__global__ void tail_kernel(const uint32_t *__restrict__ words,
                            const uint2 *__restrict__ ent0,
                            const uint2 *__restrict__ tab0,
                            int16_t *__restrict__ out, int64_t w,
                            int64_t ntiles, int64_t n_samples, int k,
                            int delta) {
  const int64_t s = blockIdx.x;
  int64_t first = 0;
  uint32_t run = 0;
  if (ntiles > 0) {
    const int64_t last = s * ntiles + ntiles - 1;
    const uint2 st = ent0[last];
    const uint2 v = tab0[last * kPhases + (st.y & 0xFFu)];
    first = (int64_t)st.x + v.x;
    run = (st.y >> 16) + (v.y >> 16);
  }
  if (first >= n_samples) return;
  int len;
  const int32_t v =
      dr::unzigzag(dr::rice_decode(words[s * w + w - 1], 0u, 0u, k, &len));
  int16_t *row = out + s * n_samples;
  for (int64_t i = first + threadIdx.x; i < n_samples; i += blockDim.x) {
    // the clamped codeword's (i - first + 1)-th repeat, mod 2^16
    const uint32_t val =
        delta ? run + (uint32_t)(i - first + 1) * (uint32_t)v : (uint32_t)v;
    row[i] = (int16_t)val;
  }
}

/* Elements per segment at each level (level 0: tiles), up to the first
 * level with one element; byte offsets of each level's tables and entry
 * states in the scratch buffer. */
struct Plan {
  int levels;  // index of the top level (n[levels] == 1), -1 without tiles
  int64_t n[kMaxLevels];
  int64_t tab[kMaxLevels];
  int64_t ent[kMaxLevels];
  int64_t bytes;
};

Plan plan(int64_t w, int64_t nseg) {
  Plan p{};
  p.levels = -1;
  const int64_t n0 = (w - 1 + kTileWords - 1) / kTileWords;
  if (n0 <= 0) return p;
  int64_t off = 0;
  int l = 0;
  for (int64_t n = n0;; n = (n + kGroup - 1) / kGroup, ++l) {
    p.n[l] = n;
    if (n == 1) break;
  }
  p.levels = l;
  for (int i = 0; i <= l; ++i) {
    if (i < l || i == 0) {  // the top level needs no table (tile 0's does)
      p.tab[i] = off;
      off += nseg * p.n[i] * kPhases * (int64_t)sizeof(uint2);
    }
    p.ent[i] = off;
    off += nseg * p.n[i] * (int64_t)sizeof(uint2);
  }
  p.bytes = off;
  return p;
}

bool grid(int64_t threads, int block, unsigned *blocks) {
  const int64_t b = (threads + block - 1) / block;
  if (b > INT_MAX) return false;
  *blocks = (unsigned)(b > 0 ? b : 1);
  return true;
}

#define DR_LAUNCH_CHECK()                     \
  do {                                        \
    const cudaError_t e = cudaGetLastError(); \
    if (e != cudaSuccess) return (int)e;      \
  } while (0)

}  // namespace

extern "C" int64_t dr_unpack_scratch_bytes(int64_t w, int64_t nseg) {
  if (w <= 0 || nseg <= 0) return 0;
  return plan(w, nseg).bytes;
}

extern "C" int dr_unpack_tables(const int32_t *words, int32_t *tab,
                                int64_t w, int64_t nseg, int k,
                                void *stream) {
  const int64_t ntiles = (w - 1 + kTileWords - 1) / kTileWords;
  if (nseg <= 0 || ntiles <= 0) return (int)cudaSuccess;
  unsigned blocks;
  if (!grid(nseg * ntiles, kBlock, &blocks)) return (int)cudaErrorInvalidValue;
  tables_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, (uint2 *)tab, w, nseg, ntiles, k);
  return (int)cudaGetLastError();
}

extern "C" int dr_unpack_decode(const int32_t *words, int16_t *out,
                                void *scratch, int64_t scratch_bytes,
                                int64_t w, int64_t nseg, int64_t n_samples,
                                int k, int delta, void *stream) {
  if (nseg <= 0 || n_samples <= 0) return (int)cudaSuccess;
  if (w <= 0 || nseg > INT_MAX) return (int)cudaErrorInvalidValue;
  const Plan p = plan(w, nseg);
  if (scratch_bytes < p.bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *wd = (const uint32_t *)words;
  char *base = (char *)scratch;
  uint2 *tab0 = nullptr, *ent0 = nullptr;
  int64_t ntiles = 0;
  unsigned blocks;
  if (p.levels >= 0) {
    ntiles = p.n[0];
    tab0 = (uint2 *)(base + p.tab[0]);
    ent0 = (uint2 *)(base + p.ent[0]);
    if (!grid(nseg * ntiles * kPhases, kBlock, &blocks))
      return (int)cudaErrorInvalidValue;  // compose's grid, the widest
    grid(nseg * ntiles, kBlock, &blocks);
    tables_kernel<<<blocks, kBlock, 0, st>>>(wd, tab0, w, nseg, ntiles, k);
    DR_LAUNCH_CHECK();
    for (int l = 0; l + 1 < p.levels; ++l) {
      grid(nseg * p.n[l + 1] * kPhases, kBlock, &blocks);
      compose_kernel<<<blocks, kBlock, 0, st>>>(
          (const uint2 *)(base + p.tab[l]), (uint2 *)(base + p.tab[l + 1]),
          nseg, p.n[l], p.n[l + 1]);
      DR_LAUNCH_CHECK();
    }
    // each segment's top-level state: phase 0, sample 0, value 0
    const cudaError_t e = cudaMemsetAsync(
        base + p.ent[p.levels], 0, nseg * sizeof(uint2), st);
    if (e != cudaSuccess) return (int)e;
    for (int l = p.levels - 1; l >= 0; --l) {
      grid(nseg * p.n[l + 1], kBlock, &blocks);
      resolve_kernel<<<blocks, kBlock, 0, st>>>(
          (const uint2 *)(base + p.tab[l]),
          (const uint2 *)(base + p.ent[l + 1]), (uint2 *)(base + p.ent[l]),
          nseg, p.n[l], p.n[l + 1]);
      DR_LAUNCH_CHECK();
    }
    grid(nseg * ntiles, kBlock, &blocks);
    decode_kernel<<<blocks, kBlock, 0, st>>>(wd, ent0, out, w, nseg, ntiles,
                                            n_samples, k, delta);
    DR_LAUNCH_CHECK();
  }
  tail_kernel<<<(unsigned)nseg, kTailBlock, 0, st>>>(
      wd, ent0, tab0, out, w, ntiles, n_samples, k, delta);
  return (int)cudaGetLastError();
}
