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
 *      starts in a tile starts at bit phase 0..24 of it. One thread per
 *      (segment, tile) walks phase 0 through the whole tile, recording for
 *      each word where that walk first starts a codeword in it and its
 *      count and sum before that start (rice_walk.h, shared with B9). The
 *      tile's assumed entry phase is the previous tile's phase-0 exit (0
 *      for a segment's first tile). A decode is a function of the bit it
 *      starts at, so the walk from the assumed entry meets phase 0's within
 *      a few codewords and then takes phase 0's remainder: one join a tile.
 *      The tile's entry is that walk's exit phase, codeword count and
 *      wrapping int16 sum. The previous tile's phase-0 exit comes from the
 *      neighbouring thread through shared memory; blocks overlap by one
 *      tile, whose thread walks phase 0 alone, so that no thread walks two
 *      tiles (a block's first thread walking its predecessor's phase 0 as
 *      well made the pass 8-10 % slower on an H100 at both decode cells'
 *      planes).
 *   2. scan: the entries are plain sums. Groups of kGroup entries compose
 *      into one entry per group (counts and sums added, the last exit
 *      kept), level by level, until one group spans the segment; then,
 *      from each segment's known start (phase 0, sample 0, value 0), each
 *      group's entry state is walked down through its members to every
 *      tile: its entry phase, its first sample index and the running value
 *      before it.
 *   3. check and repair: a tile's assumption is right when the previous
 *      tile, walked from its own assumption, exits at the phase the tile
 *      assumed. Pass 1 flags the tile after each one whose walk from its
 *      assumption exits elsewhere than its phase-0 walk, and keeps each
 *      segment's first flag. Up to that tile every assumption is right, by
 *      induction from the segment's start, so the states of pass 2 are
 *      exact there. One warp per flagged segment then goes on in order,
 *      32 tiles at a time: each tile whose true entry (the exit of the
 *      tile before it, as repaired) differs from its assumption, and whose
 *      first sample lies below n_samples, is walked again from its true
 *      entry, alone, and the warp rewrites every state from the first flag
 *      on. Past n_samples no state is read, so a walk that never meets
 *      phase 0's (zero padding's 25-bit escapes never do) costs nothing
 *      there. Such walks below n_samples (a short segment decoded to the
 *      length of the others, rows of escapes, streams that never join)
 *      would make the warp walk tile after tile, so a warp that meets a
 *      chain of more than kChain tiles, or more than kSerial tiles in all,
 *      hands the rest of its segment on, with no host round trip:
 *      3b. one thread per tile of such a segment from there on walks it
 *          from every entry phase, as the 25-phase tables did, and keeps
 *          only the exits (32 bytes a tile);
 *      3c. one block per such segment composes each thread's run of those
 *          maps, chains the runs from the known entry, walks again every
 *          tile whose true entry differs from its assumption, and writes
 *          the states, keeping the new walks below n_samples alone.
 *      The result is the same as the warp's would be, in a time bounded by
 *      one walk from every phase a tile, spread over the card, and a short
 *      serial chain of maps. (On an H100, two 500,000-sample rows that
 *      never join took 39.5 ms with the warp alone, 0.86 ms handed on
 *      after 4 tiles in a row to blocks of 256 threads, 0.73 ms after 2 to
 *      blocks of 1024, and 0.74 ms through the 25-phase tables; the
 *      benchmark's planes hand no segment on at either setting.) The tiles walked again are added to a device
 *      counter (tracing.counters["tiles_rejoined"]). Nothing waits for the
 *      host; a segment without a flag costs its warp one load, and passes
 *      3b and 3c one load a thread when no segment is handed on. (The
 *      25-phase tables kept for every segment would need their 200 bytes a
 *      tile, and their composition alone took 0.55 ms of a NOPTREX call on
 *      an H100, more than this whole pass there.)
 *   4. decode: one warp per 32 consecutive tiles, one lane a tile. Tile
 *      t's samples are out[s, first .. first + count), its codewords'
 *      count clamped at n_samples: passes 2 and 3 make every first sample
 *      the sum of the counts before it, so each lane knows where its
 *      samples go before it decodes one. Lanes decode from their entry
 *      phase kRound samples a round (the walk bounded by that count, its
 *      cursor kept in registers from round to round) into their own slot
 *      of shared memory, each sample at its phase in out's 8-byte words.
 *      After a __syncwarp the warp stores each lane's round in turn, lane
 *      u storing its word u: 32 consecutive aligned 8-byte words a store
 *      (wherever out starts), sample by sample only in a round's first and
 *      last word. (One thread a tile storing its own samples, four to an
 *      8-byte store, touched 32 lines some 436 bytes apart a store; on an
 *      H100 those stores took 67-82 % of the pass at the benchmark's
 *      planes, and this pass takes 57-73 % less time there.)
 *   5. tail: the cursor of the serial decode is clamped at 32 * (W - 1), as
 *      the reference's scan decoder (ops/pack_xla.py::unpack_bits) clamps
 *      it, so every sample past the last codeword that starts before the
 *      clamp re-decodes the codeword at the clamp (the pad word) and, with
 *      the delta inverse, keeps accumulating it. One block per segment
 *      fills those samples arithmetically.
 *
 * Scratch: an entry and a state (8 bytes each) and a map (32 bytes) a
 * tile, the upper levels' (1/32 of that and less) and 36 bytes a segment.
 * Bound: not bytes.
 * Passes 1 and 4 are each a walk of every codeword of the tile (pass 1
 * also the join's few, pass 4 only those below n_samples); passes 2, 3
 * and 5 are short.
 * Words are read segment-major (row s contiguous), samples written
 * segment-major, so the codec needs no transpose around the kernel.
 * dr_unpack_tables keeps the walk from every one of the 25 entry phases
 * (phase_tables_kernel), the oracle that tests hold pass 1 against.
 */
#include <cuda_runtime.h>
#include <limits.h>

#include "kernels.h"
#include "rice_walk.h"
#include "smem_check.h"

namespace {

constexpr int kTileWords = 32;               // words per tile
constexpr int kTileBits = 32 * kTileWords;
constexpr int kPhases = 25;                  // entry phases 0..24
constexpr int kGroup = 32;                   // entries composed per group
constexpr int kBlock = 128;
constexpr int kTailBlock = 256;
constexpr int kMaxLevels = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
// a segment's top-level entry state and its flag, zeroed together (with
// the count of segments that pass 3 hands on)
constexpr int64_t kTopBytes = sizeof(uint2) + sizeof(uint32_t);
constexpr int kChain = 2;          // pass 3: tiles in a row a warp walks again
constexpr int kSerial = 32;        // and in all, before passes 3b and 3c
constexpr int kMapBytes = 32;      // a tile's exit from each entry phase
constexpr int kMapBlocks = 1024;   // pass 3b's grid
constexpr int kChainBlock = 1024;  // pass 3c's block
constexpr int kChainBlocks = 1024; // and its grid, at most
// pass 4: samples a lane decodes a round, a multiple of 4 (so that a
// lane's rounds keep one phase in out's 8-byte words) whose round spans at
// most 32 such words, one a lane; a lane's slot in 8-byte words, one more
// so that neighbouring lanes' slots start in different banks
constexpr int kRound = 124;
constexpr int kSlot = kRound / 4 + 2;
static_assert(kRound % 4 == 0 && kRound / 4 + 1 == 32, "a word a lane");

/* A tile's entry or an entry state is a uint2: x = codeword count (or first
 * sample index), y = (int16 sum or running value) << 16 | phase. A tile's
 * entry of pass 1 also holds the phase it was walked from at bits 8..12 of
 * y; the exit phase is y & 0xFF. */
__device__ __forceinline__ uint2 entry(uint32_t n, uint32_t value,
                                       uint32_t phase) {
  return make_uint2(n, (value << 16) | phase);
}

__device__ __forceinline__ uint2 walked(const dr::Walked &r, uint32_t from) {
  return entry(r.count, r.sum & 0xFFFFu, (from << 8) | r.exit);
}

__device__ __forceinline__ uint32_t load_word(const uint32_t *__restrict__ row,
                                              int64_t i, int64_t w) {
  return i < w ? __ldg(row + i) : 0u;
}

__device__ __forceinline__ int tile_bits(int64_t t0, int64_t w) {
  return (int)min((int64_t)kTileBits, 32 * (w - 1) - 32 * t0);
}

/* Pass 1: tab[s * ntiles + t], one thread per (segment, tile); thread 0 of
 * a block holds the tile before the block's first and walks only its phase
 * 0. rec[j][thread] = phase 0's first start in word j > 0 of the tile: its
 * bit in the word (5 bits), the codewords before it (11 bits: a tile holds
 * at most 1024) and their wrapping sum (16 bits). flagged[s] = ntiles - the
 * segment's first flagged tile, 0 without one. */
__global__ void tables_kernel(const uint32_t *__restrict__ words,
                              uint2 *__restrict__ tab,
                              uint32_t *__restrict__ flagged, int64_t w,
                              int64_t nseg, int64_t ntiles, int k) {
  DR_SHARED(uint32_t, rec, [kTileWords][kBlock]);
  DR_SHARED(uint32_t, exit0, [kBlock]);
  DR_SMEM_ENTRY(rec, exit0);
  const int64_t g = (int64_t)blockIdx.x * (kBlock - 1) + threadIdx.x - 1;
  const bool live = g >= 0 && g < nseg * ntiles;
  const int64_t s = live ? g / ntiles : 0, t = live ? g % ntiles : 0;
  const uint32_t *row = words + s * w;
  const int64_t t0 = t * kTileWords;
  const int lim = tile_bits(t0, w);
  const auto load = [row, t0, w](int i) { return load_word(row, t0 + i, w); };
  DR_SMEM_PTR(uint32_t) mine = DR_SM2_FROM(rec, 0, threadIdx.x);
  uint32_t a0 = 0u, a1 = 0u, a2 = 0u;
  dr::Walked p0{0u, 0u, 0u};
  if (live) {
    // every walk starts in the tile's first word: its window stays loaded
    a0 = load_word(row, t0, w);
    a1 = load_word(row, t0 + 1, w);
    a2 = load_word(row, t0 + 2, w);
    p0 = dr::walk_phase0(load, lim, k, a0, a1, a2, mine, kBlock);
  }
  DR_SM(exit0, threadIdx.x) = p0.exit;
  DR_SYNCTHREADS();
  if (!live || threadIdx.x == 0) return;
  const uint32_t a = t == 0 ? 0u : DR_SM(exit0, threadIdx.x - 1);
  const dr::Walked me =
      a == 0 ? p0
             : dr::walk_joined(load, (int)a, lim, k, a0, a1, a2, mine, kBlock,
                               p0);
  tab[g] = walked(me, a);
  // the next tile assumes this tile's phase-0 exit, which is its true entry
  // only if this tile's own walk exits there
  if (me.exit != p0.exit && t + 1 < ntiles)
    atomicMax(flagged + s, (uint32_t)(ntiles - 1 - t));
}

/* dr_unpack_tables: tab[(s * ntiles + t) * kPhases + phase], the walk from
 * every entry phase, one thread per (segment, tile). Each phase is a loop
 * of its own, joined with phase 0's record. */
__global__ void phase_tables_kernel(const uint32_t *__restrict__ words,
                                    uint2 *__restrict__ tab, int64_t w,
                                    int64_t nseg, int64_t ntiles, int k) {
  DR_SHARED(uint32_t, rec, [kTileWords][kBlock]);
  DR_SMEM_ENTRY(rec);
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg * ntiles) return;
  const int64_t s = g / ntiles, t = g % ntiles;
  const uint32_t *row = words + s * w;
  const int64_t t0 = t * kTileWords;
  const int lim = tile_bits(t0, w);
  uint2 *out = tab + g * kPhases;
  const uint32_t a0 = load_word(row, t0, w), a1 = load_word(row, t0 + 1, w),
                 a2 = load_word(row, t0 + 2, w);
  const auto load = [row, t0, w](int i) { return load_word(row, t0 + i, w); };
  DR_SMEM_PTR(uint32_t) mine = DR_SM2_FROM(rec, 0, threadIdx.x);
  const dr::Walked p0 =
      dr::walk_phase0(load, lim, k, a0, a1, a2, mine, kBlock);
  out[0] = entry(p0.count, p0.sum & 0xFFFFu, p0.exit);
  for (int e = 1; e < kPhases; ++e) {
    const dr::Walked r =
        dr::walk_joined(load, e, lim, k, a0, a1, a2, mine, kBlock, p0);
    out[e] = entry(r.count, r.sum & 0xFFFFu, r.exit);
  }
}

/* Pass 2, up: entry of group grp at level l + 1 = its members at level l
 * (n per segment) in order: their counts and sums, the last one's exit. */
__global__ void compose_kernel(const uint2 *__restrict__ tab,
                               uint2 *__restrict__ up, int64_t nseg,
                               int64_t n, int64_t nup) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg * nup) return;
  const int64_t s = g / nup, grp = g % nup;
  const uint2 *base = tab + s * n;
  const int64_t j1 = min(grp * kGroup + kGroup, n);
  uint32_t e = 0, count = 0, sum = 0;
  for (int64_t j = grp * kGroup; j < j1; ++j) {
    const uint2 v = base[j];
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
    const uint2 v = tab[s * n + j];
    first += v.x;
    run = (run + (v.y >> 16)) & 0xFFFFu;
    e = v.y & 0xFFu;
  }
}

/* Pass 3, in order: one warp per segment. Each round takes 32 tiles: a
 * warp prefix sum gives each its first sample and running value, the first
 * tile whose true entry differs from the phase it was walked from, below
 * n_samples, is walked again by the whole warp (the same words on every
 * lane), and the round repeats until none is left; then the round's states
 * (and repaired entries) are written and its totals carry into the next.
 * A warp that would walk a (kChain + 1)-th tile in a row, or a (kSerial +
 * 1)-th in all, stops there instead: it writes the states before that
 * tile, its state to stuck[s] (tile, first sample, running value, entry
 * phase) and the segment to the list that passes 3b and 3c take. */
__global__ void repair_kernel(const uint32_t *__restrict__ words,
                              uint2 *__restrict__ tab,
                              uint2 *__restrict__ ent,
                              const uint32_t *__restrict__ flagged,
                              uint4 *__restrict__ stuck,
                              uint32_t *__restrict__ list,
                              uint32_t *__restrict__ nstuck,
                              unsigned long long *rejoined, int64_t w,
                              int64_t nseg, int64_t ntiles,
                              int64_t n_samples, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (s >= nseg) return;  // the whole warp leaves
  const uint32_t f = flagged[s];
  if (f == 0) return;
  int64_t c0 = ntiles - f;  // the first flagged tile
  uint2 *tabs = tab + s * ntiles;
  uint2 *ents = ent + s * ntiles;
  const uint2 st = ents[c0];  // exact: every tile before it entered right
  if ((int64_t)st.x >= n_samples) return;
  uint32_t first = st.x, run = st.y >> 16, e = st.y & 0xFFu, redone = 0;
  int chain = 0;
  int64_t last = -2;  // the tile walked again last
  const uint32_t *row = words + s * w;
  for (; c0 < ntiles; c0 += 32) {
    const int64_t t = c0 + lane;
    const bool live = t < ntiles;
    uint2 v = live ? tabs[t] : make_uint2(0u, 0u);
    bool again = false;
    uint32_t n, sum, prev;
    int stop = 32;  // the first lane left to passes 3b and 3c
    for (;;) {
      n = v.x;
      sum = v.y >> 16;
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t pn = __shfl_up_sync(kFull, n, d);
        const uint32_t ps = __shfl_up_sync(kFull, sum, d);
        if (lane >= d) {
          n += pn;
          sum += ps;
        }
      }
      prev = __shfl_up_sync(kFull, v.y & 0xFFu, 1);
      if (lane == 0) prev = e;
      const unsigned bad = __ballot_sync(
          kFull, live && prev != ((v.y >> 8) & 0xFFu) &&
                     (int64_t)(first + n - v.x) < n_samples);
      if (!bad) break;
      const int i = __ffs(bad) - 1;
      chain = c0 + i == last + 1 ? chain + 1 : 1;
      if (chain > kChain || redone == (uint32_t)kSerial) {
        stop = i;
        break;
      }
      last = c0 + i;
      const uint32_t from = __shfl_sync(kFull, prev, i);
      const int64_t i0 = (c0 + i) * kTileWords;
      const auto iload = [row, i0, w](int j) {
        return load_word(row, i0 + j, w);
      };
      const dr::Walked r =
          dr::walk_from(iload, (int)from, tile_bits(i0, w), k,
                        load_word(row, i0, w), load_word(row, i0 + 1, w),
                        load_word(row, i0 + 2, w));
      if (lane == i) {
        v = walked(r, from);
        again = true;
      }
      ++redone;
    }
    if (live && lane < stop) {
      ents[t] = entry(first + n - v.x, (run + sum - (v.y >> 16)) & 0xFFFFu,
                      (v.y >> 8) & 0xFFu);
      if (again) tabs[t] = v;
    }
    if (stop < 32) {
      if (lane == stop) {
        stuck[s] = make_uint4((uint32_t)t, first + n - v.x,
                              (run + sum - (v.y >> 16)) & 0xFFFFu, prev);
        list[atomicAdd(nstuck, 1u)] = (uint32_t)s;
      }
      break;
    }
    first += __shfl_sync(kFull, n, 31);
    run = (run + __shfl_sync(kFull, sum, 31)) & 0xFFFFu;
    e = __shfl_sync(kFull, v.y & 0xFFu, 31);
  }
  if (lane == 0 && redone > 0 && rejoined != nullptr)
    atomicAdd(rejoined, (unsigned long long)redone);
}

/* Pass 3b: for every tile of a listed segment from its stuck tile on, the
 * exit phase of the walk from each entry phase (phase 0's walk, then the
 * other 24 joined with it), as bytes 0..24 of maps[s * ntiles + t]. The
 * threads of the grid go through the listed tiles in turn. */
__global__ void maps_kernel(const uint32_t *__restrict__ words,
                            uint8_t *__restrict__ maps,
                            const uint4 *__restrict__ stuck,
                            const uint32_t *__restrict__ list,
                            const uint32_t *__restrict__ nstuck, int64_t w,
                            int64_t ntiles, int k) {
  DR_SHARED(uint32_t, rec, [kTileWords][kBlock]);
  DR_SMEM_ENTRY(rec);
  const int64_t total = (int64_t)*nstuck * ntiles;
  DR_SMEM_PTR(uint32_t) mine = DR_SM2_FROM(rec, 0, threadIdx.x);
  for (int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; x < total;
       x += (int64_t)gridDim.x * blockDim.x) {
    const int64_t s = list[x / ntiles], t = x % ntiles;
    if (t < (int64_t)stuck[s].x) continue;
    const uint32_t *row = words + s * w;
    const int64_t t0 = t * kTileWords;
    const int lim = tile_bits(t0, w);
    const auto load = [row, t0, w](int i) { return load_word(row, t0 + i, w); };
    const uint32_t a0 = load_word(row, t0, w), a1 = load_word(row, t0 + 1, w),
                   a2 = load_word(row, t0 + 2, w);
    uint8_t *out = maps + (s * ntiles + t) * kMapBytes;
    const dr::Walked p0 =
        dr::walk_phase0(load, lim, k, a0, a1, a2, mine, kBlock);
    out[0] = (uint8_t)p0.exit;
    for (int e = 1; e < kPhases; ++e)
      out[e] = (uint8_t)dr::walk_joined(load, e, lim, k, a0, a1, a2, mine,
                                        kBlock, p0)
                   .exit;
  }
}

/* Byte i (< 32) of the map held in (a, b). */
__device__ __forceinline__ uint32_t map_at(const uint4 &a, const uint4 &b,
                                           uint32_t i) {
  const uint4 &h = i < 16 ? a : b;
  const uint32_t j = i & 15;
  const uint32_t x = j < 8 ? (j < 4 ? h.x : h.y) : (j < 12 ? h.z : h.w);
  return (x >> (8 * (j & 3))) & 0xFFu;
}

constexpr int kChainWarps = kChainBlock / 32;

/* Exclusive prefix sums of (a, b) over the block's kChainBlock threads;
 * part holds 2 * kChainWarps words. */
__device__ __forceinline__ uint2 block_prefix(uint32_t a, uint32_t b,
                                              DR_SMEM_PTR(uint32_t) part) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint32_t ia = a, ib = b;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t pa = __shfl_up_sync(kFull, ia, d);
    const uint32_t pb = __shfl_up_sync(kFull, ib, d);
    if (lane >= d) {
      ia += pa;
      ib += pb;
    }
  }
  if (lane == 31) {
    DR_SM(part, wid) = ia;
    DR_SM(part, kChainWarps + wid) = ib;
  }
  DR_SYNCTHREADS();
  uint32_t ea = ia - a, eb = ib - b;
  for (int j = 0; j < wid; ++j) {
    ea += DR_SM(part, j);
    eb += DR_SM(part, kChainWarps + j);
  }
  DR_SYNCTHREADS();  // part is written again by the next call
  return make_uint2(ea, eb);
}

/* The least x over the block's kChainBlock threads. */
__device__ __forceinline__ uint32_t block_min(uint32_t x,
                                              DR_SMEM_PTR(uint32_t) part) {
  x = __reduce_min_sync(kFull, x);
  if ((threadIdx.x & 31) == 0) DR_SM(part, threadIdx.x >> 5) = x;
  DR_SYNCTHREADS();
  for (int j = 0; j < kChainWarps; ++j) x = min(x, DR_SM(part, j));
  DR_SYNCTHREADS();
  return x;
}

/* Pass 3c: one block per listed segment, from its stuck tile j on. Each
 * thread composes the maps of its run of consecutive tiles; one thread
 * chains the runs from the stuck state's entry phase; each thread then
 * has every one of its tiles' true entry phase, walks again each tile
 * whose true entry differs from the phase it was walked from (the walk
 * goes to the tile's map slot), and the block finds the first tile whose
 * first sample reaches n_samples. The tiles before it take their new
 * walks; the block writes every state from tile j on. */
__global__ void __launch_bounds__(kChainBlock)
    chain_kernel(const uint32_t *__restrict__ words, uint2 *__restrict__ tab,
                 uint2 *__restrict__ ent, uint8_t *__restrict__ maps,
                 const uint4 *__restrict__ stuck,
                 const uint32_t *__restrict__ list,
                 const uint32_t *__restrict__ nstuck,
                 unsigned long long *rejoined, int64_t w, int64_t ntiles,
                 int64_t n_samples, int k) {
  DR_SHARED(uint8_t, cm, [kPhases][kChainBlock]);
  DR_SHARED(uint8_t, ein, [kChainBlock]);
  DR_SHARED(uint32_t, sums, [2][kChainWarps]);
  DR_SMEM_ENTRY(cm, ein, sums);
  DR_SMEM_PTR(uint32_t) part = DR_SM2_FROM(sums, 0, 0);
  const int tid = threadIdx.x;
  const uint32_t nlisted = *nstuck;
  for (uint32_t i = blockIdx.x; i < nlisted; i += gridDim.x) {
    const int64_t s = list[i];
    const uint4 c = stuck[s];
    const int64_t j = c.x, q = (ntiles - j + kChainBlock - 1) / kChainBlock;
    const int64_t lo = min(j + tid * q, ntiles), hi = min(lo + q, ntiles);
    uint2 *tabs = tab + s * ntiles;
    uint2 *ents = ent + s * ntiles;
    const uint4 *m = reinterpret_cast<const uint4 *>(maps + s * ntiles *
                                                             kMapBytes);
    uint2 *fresh = reinterpret_cast<uint2 *>(maps + s * ntiles * kMapBytes);
    constexpr int kStep = kMapBytes / (int)sizeof(uint2);
    // the run's map: the exit of its last tile from each entry phase
    for (int e = 0; e < kPhases; ++e) DR_SM2(cm, e, tid) = (uint8_t)e;
    for (int64_t t = lo; t < hi; ++t) {
      const uint4 a = m[2 * t], b = m[2 * t + 1];
      for (int e = 0; e < kPhases; ++e)
        DR_SM2(cm, e, tid) = (uint8_t)map_at(a, b, DR_SM2(cm, e, tid));
    }
    DR_SYNCTHREADS();
    if (tid == 0) {
      const int64_t runs = (ntiles - j + q - 1) / q;
      uint32_t x = c.w;
      for (int r = 0; r < runs; ++r) {
        DR_SM(ein, r) = (uint8_t)x;
        x = DR_SM2(cm, x, r);
      }
    }
    DR_SYNCTHREADS();
    const uint32_t *row = words + s * w;
    uint32_t x = lo < hi ? DR_SM(ein, tid) : 0u, cnt = 0, sum = 0;
    for (int64_t t = lo; t < hi; ++t) {
      uint2 v = tabs[t];
      if (x != ((v.y >> 8) & 0xFFu)) {
        const int64_t t0 = t * kTileWords;
        const auto load = [row, t0, w](int r) {
          return load_word(row, t0 + r, w);
        };
        v = walked(dr::walk_from(load, (int)x, tile_bits(t0, w), k,
                                 load_word(row, t0, w),
                                 load_word(row, t0 + 1, w),
                                 load_word(row, t0 + 2, w)),
                   x);
      }
      fresh[kStep * t] = v;
      cnt += v.x;
      sum += v.y >> 16;
      x = v.y & 0xFFu;
    }
    // the first tile whose first sample reaches n_samples (tiles - j: none)
    uint32_t at = (uint32_t)(ntiles - j);
    int64_t first = (int64_t)c.y + block_prefix(cnt, 0u, part).x;
    for (int64_t t = lo; t < hi; ++t) {
      if (first >= n_samples) {
        at = (uint32_t)(t - j);
        break;
      }
      first += fresh[kStep * t].x;
    }
    const int64_t cut = j + block_min(at, part);
    uint32_t redone = 0;
    cnt = 0;
    sum = 0;
    for (int64_t t = lo; t < hi; ++t) {
      uint2 v = tabs[t];
      const uint2 u = fresh[kStep * t];
      if (t < cut && (u.x != v.x || u.y != v.y)) {
        tabs[t] = v = u;
        ++redone;
      }
      cnt += v.x;
      sum += v.y >> 16;
    }
    const uint2 pre = block_prefix(cnt, sum, part);
    uint32_t fs = c.y + pre.x, rs = c.z + pre.y;
    for (int64_t t = lo; t < hi; ++t) {
      const uint2 v = tabs[t];
      ents[t] = entry(fs, rs & 0xFFFFu, (v.y >> 8) & 0xFFu);
      fs += v.x;
      rs += v.y >> 16;
    }
    redone = __reduce_add_sync(kFull, redone);
    if ((tid & 31) == 0 && redone > 0 && rejoined != nullptr)
      atomicAdd(rejoined, (unsigned long long)redone);
    DR_SYNCTHREADS();  // cm and ein are written again for the next segment
  }
}

/* Pass 4: one warp per 32 consecutive tiles (g = s * ntiles + t), one lane
 * a tile, decoding kRound samples a round into its slot; the warp then
 * stores each lane's round in turn, lane u its word u. A round's first and
 * last word, which it may share with the lane's previous and next round,
 * go sample by sample. */
__global__ void __launch_bounds__(kBlock)
    decode_kernel(const uint32_t *__restrict__ words,
                  const uint2 *__restrict__ ent, const uint2 *__restrict__ tab,
                  int16_t *__restrict__ out, int64_t w, int64_t nseg,
                  int64_t ntiles, int64_t n_samples, int k, int delta) {
  DR_SHARED(uint64_t, slots, [kBlock][kSlot]);
  DR_SMEM_ENTRY(slots);
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
  const int64_t total = nseg * ntiles;
  const int64_t g = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (g - lane >= total) return;  // the whole warp leaves
  // out from the 8-byte boundary at or before it, ph samples before out
  const int64_t ph = (int64_t)((reinterpret_cast<uintptr_t>(out) >> 1) & 3);
  int16_t *const o16 = out - ph;
  uint64_t *const o64 = reinterpret_cast<uint64_t *>(o16);
  uint32_t cnt = 0, run = 0;
  int64_t q = 0;  // the tile's first sample in o16
  const uint32_t *tw = words;
  int left = 0;  // words of the row from the tile's first
  dr::Cursor c{0, 0, 0u, 0u, 0u};
  if (g < total) {
    const int64_t s = g / ntiles, t0 = (g - s * ntiles) * kTileWords;
    const uint2 st = ent[g];
    if ((int64_t)st.x < n_samples) {
      // the next tile of the row starts at st.x + tab[g].x: passes 2 and 3
      // write every first sample as the sum of the counts before it
      cnt = (uint32_t)min((int64_t)tab[g].x, n_samples - (int64_t)st.x);
      q = s * n_samples + (int64_t)st.x + ph;
      run = st.y >> 16;
      tw = words + s * w + t0;
      left = (int)(w - t0);
      c.b = (int)(st.y & 0xFFu);
    }
  }
  const auto load = [tw, left](int i) {
    return i < left ? __ldg(tw + i) : 0u;
  };
  if (cnt > 0) {
    c.w0 = load(0);
    c.w1 = load(1);
    c.w2 = load(2);
  }
  DR_SMEM_PTR(int16_t) mine = DR_SM_ROW_AS(int16_t, slots, threadIdx.x);
  const int off = (int)(q & 3);
  auto put = [&](int32_t v, int i) {
    run = delta ? run + (uint32_t)v : (uint32_t)v;
    DR_SM(mine, off + i) = (int16_t)run;
  };
  const uint32_t most = __reduce_max_sync(kFull, cnt);
  for (uint32_t r = 0; r < most; r += kRound) {
    const int n = cnt > r ? (int)min(cnt - r, (uint32_t)kRound) : 0;
    dr::walk_count(load, c, n, k, put);
    DR_SYNCWARP();  // the slots are written
    const int64_t at = (q >> 2) + (int64_t)(r >> 2);  // the round's word 0
    const int key = (off << 16) | n;
    for (int j = 0; j < 32; ++j) {
      const int64_t aj = __shfl_sync(kFull, at, j);
      const int kj = __shfl_sync(kFull, key, j);
      // word lane of lane j's round holds its samples lo .. lo + 3
      const int nj = kj & 0xFFFF, lo = 4 * lane - (kj >> 16);
      if (lo + 4 > 0 && lo < nj) {
        const uint64_t v = DR_SM2(slots, warp0 + j, lane);
        if (lo >= 0 && lo + 4 <= nj) {
          o64[aj + lane] = v;
        } else {
          for (int m = max(-lo, 0); m < min(nj - lo, 4); ++m)
            o16[4 * (aj + lane) + m] = (int16_t)(v >> (16 * m));
        }
      }
    }
    DR_SYNCWARP();  // the slots are read before the next round writes them
  }
}

/* Pass 5: one block per segment fills [count of codewords before the
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
    const uint2 st = ent0[last], v = tab0[last];
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
 * level with one element; byte offsets of each level's entries and entry
 * states, of the segments' flags, of the count of segments listed for
 * passes 3b and 3c, of their stuck states, list and maps in the scratch
 * buffer. The top level's states, the flags and the count lie together,
 * zeroed by one memset. Level 0's entries start the buffer. */
struct Plan {
  int levels;  // index of the top level (n[levels] == 1), -1 without tiles
  int64_t n[kMaxLevels];
  int64_t tab[kMaxLevels];
  int64_t ent[kMaxLevels];
  int64_t flags, nstuck, stuck, list, maps;
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
    if (i < l || i == 0) {  // the top level needs no entries (tile 0's do)
      p.tab[i] = off;
      off += nseg * p.n[i] * (int64_t)sizeof(uint2);
    }
    p.ent[i] = off;
    off += nseg * p.n[i] * (int64_t)sizeof(uint2);
  }
  p.flags = off;
  off += nseg * (int64_t)sizeof(uint32_t);
  p.nstuck = off;
  off = (off + (int64_t)sizeof(uint32_t) + 15) & ~(int64_t)15;
  p.stuck = off;
  off += nseg * (int64_t)sizeof(uint4);
  p.list = off;
  off = (off + nseg * (int64_t)sizeof(uint32_t) + 15) & ~(int64_t)15;
  p.maps = off;
  off += nseg * n0 * kMapBytes;
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

/* Passes 1-3 on stream st: every tile's entry (level 0 of the plan) walked
 * from its true entry phase below n_samples, and its entry state. */
int queue_entries(const uint32_t *wd, char *base, const Plan &p, int64_t w,
                  int64_t nseg, int64_t n_samples, int k,
                  unsigned long long *rejoined, cudaStream_t st) {
  const int64_t ntiles = p.n[0];
  unsigned blocks;
  if (!grid(nseg * ntiles + 1, kBlock - 1, &blocks) ||
      !grid(32 * nseg, kBlock, &blocks))
    return (int)cudaErrorInvalidValue;
  // each segment's top-level state (phase 0, sample 0, value 0), no flags,
  // no segment listed
  const cudaError_t e = cudaMemsetAsync(
      base + p.ent[p.levels], 0, nseg * kTopBytes + sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  uint2 *tab0 = (uint2 *)(base + p.tab[0]);
  uint2 *ent0 = (uint2 *)(base + p.ent[0]);
  uint32_t *flags = (uint32_t *)(base + p.flags);
  grid(nseg * ntiles + 1, kBlock - 1, &blocks);
  tables_kernel<<<blocks, kBlock, 0, st>>>(wd, tab0, flags, w, nseg, ntiles,
                                           k);
  DR_LAUNCH_CHECK();
  for (int l = 0; l + 1 < p.levels; ++l) {
    grid(nseg * p.n[l + 1], kBlock, &blocks);
    compose_kernel<<<blocks, kBlock, 0, st>>>(
        (const uint2 *)(base + p.tab[l]), (uint2 *)(base + p.tab[l + 1]),
        nseg, p.n[l], p.n[l + 1]);
    DR_LAUNCH_CHECK();
  }
  for (int l = p.levels - 1; l >= 0; --l) {
    grid(nseg * p.n[l + 1], kBlock, &blocks);
    resolve_kernel<<<blocks, kBlock, 0, st>>>(
        (const uint2 *)(base + p.tab[l]),
        (const uint2 *)(base + p.ent[l + 1]), (uint2 *)(base + p.ent[l]),
        nseg, p.n[l], p.n[l + 1]);
    DR_LAUNCH_CHECK();
  }
  if (ntiles > 1) {
    uint32_t *nstuck = (uint32_t *)(base + p.nstuck);
    uint4 *stuck = (uint4 *)(base + p.stuck);
    uint32_t *list = (uint32_t *)(base + p.list);
    uint8_t *maps = (uint8_t *)(base + p.maps);
    grid(32 * nseg, kBlock, &blocks);
    repair_kernel<<<blocks, kBlock, 0, st>>>(wd, tab0, ent0, flags, stuck,
                                             list, nstuck, rejoined, w, nseg,
                                             ntiles, n_samples, k);
    DR_LAUNCH_CHECK();
    maps_kernel<<<kMapBlocks, kBlock, 0, st>>>(wd, maps, stuck, list, nstuck,
                                               w, ntiles, k);
    DR_LAUNCH_CHECK();
    const unsigned chains =
        nseg < kChainBlocks ? (unsigned)nseg : (unsigned)kChainBlocks;
    chain_kernel<<<chains, kChainBlock, 0, st>>>(wd, tab0, ent0, maps, stuck,
                                                 list, nstuck, rejoined, w,
                                                 ntiles, n_samples, k);
    DR_LAUNCH_CHECK();
  }
  return (int)cudaSuccess;
}

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
  phase_tables_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)words, (uint2 *)tab, w, nseg, ntiles, k);
  return (int)cudaGetLastError();
}

extern "C" int dr_unpack_decode(const int32_t *words, int16_t *out,
                                void *scratch, int64_t scratch_bytes,
                                int64_t w, int64_t nseg, int64_t n_samples,
                                int k, int delta,
                                unsigned long long *rejoined, void *stream) {
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
    if (!grid(nseg * ntiles, kBlock, &blocks))
      return (int)cudaErrorInvalidValue;
    const int rc =
        queue_entries(wd, base, p, w, nseg, n_samples, k, rejoined, st);
    if (rc != (int)cudaSuccess) return rc;
    decode_kernel<<<blocks, kBlock, 0, st>>>(wd, ent0, tab0, out, w, nseg,
                                            ntiles, n_samples, k, delta);
    DR_LAUNCH_CHECK();
  }
  tail_kernel<<<(unsigned)nseg, kTailBlock, 0, st>>>(
      wd, ent0, tab0, out, w, ntiles, n_samples, k, delta);
  return (int)cudaGetLastError();
}
