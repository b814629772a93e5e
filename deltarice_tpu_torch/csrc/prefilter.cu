/* The generic pre-filter inverse: every filter but the delta, whose
 * inverse B2 fuses. The forward filter (dr_fir_encode) follows it, below.
 *
 * Replaces deltarice_tpu/ops/prefilter.py::_iir_decode, which is no Pallas
 * kernel but a jitted lax.scan: XLA compiles it into one device loop over
 * the samples, every row of the batch in each step. Per row:
 *
 *   out[i] = wrap16(d[i] - sum_{j>=1} c16(filt[j]) * out[i - j]) / f0,
 *
 * f0 = c16(filt[0]), out[i - j] = 0 before the row starts, the division
 * truncating toward zero on the wrapped int16 numerator (C's, and
 * lax.div's), the quotient wrapped to int16 (-32768 / -1 gives -32768).
 * f0 == 0 gives -1, XLA's signed division by zero; f0 == +-1 skips the
 * division. Products and sums run in uint32 (mod 2^32, which agrees mod
 * 2^16 and cannot overflow); only the int16 numerator is divided.
 *
 * Bound: device-memory bytes (each sample read once and written once).
 * The recurrence is serial along a row, so the design's question is how
 * to fill 132 SMs with independent walks. Two paths:
 *
 * Blocked (dr_iir_blocked): f0 == +-1 and at most 8 history taps, which
 * covers every filter optimize() chooses. The sign folds into the taps and
 * the input, and the recurrence is then linear over Z/2^16 in the input
 * and the history. A row is cut into blocks of L samples; each block is a
 * "virtual row", and a block's exit history (its last T = nhist outputs,
 * newest first) is M * entry + e, where M (T x T, the same for every full
 * block; the wrapper computes it on the host, ops/prefilter_model.py) maps
 * the entry history under zero input and e is the block walked from a zero
 * history. Pass A walks every full block but the last of each row from
 * zero and keeps only e (16 bytes a block, the carry tensor, block-major
 * so that pass B's warps move whole lines); pass B, a thread a row, runs s_{b+1} = M s_b + e_b over the blocks in place, each
 * e loaded 16 steps ahead of the chain (pass A has just written them, so
 * they come from L2); pass C walks every block again from its entry
 * history and stores. A and C read the input once each: 1.5x the bound's
 * bytes. With one block a row (n <= L) or no history only pass C runs.
 *
 * Serial (dr_iir_decode): everything else (lossy leading taps, f0 == 0,
 * more than 8 history taps), one thread a row: pass C with L = n.
 *
 * Passes A and C are exit_kernel and walk_kernel, one body of two names so
 * that a profiler's trace tells them apart; pass B is carry_kernel. Both
 * walks work alike. A block is one warp and owns 32 virtual
 * rows. It stages tiles of 32 rows x 256 samples into shared memory 16
 * bytes a lane by cp.async, the next tile in flight while the warp walks
 * the current one in place (one buffer when a walk has a single tile), and
 * writes each tile back 16 bytes a lane: neither the loads nor the stores
 * stride by a row. Where every row of the warp fills the tile, a row costs
 * the staging one broadcast shared load of its start and one 16-byte copy
 * a lane; the ragged tiles check each row's length. The walker reads and
 * writes its row 8 samples (16 bytes) at a time; the row pitch of 264
 * int16s (528 bytes, 132 words) puts the 8 lanes of each quarter-warp on
 * distinct 4-bank groups, so those 128-bit accesses are free of bank
 * conflicts. Up to 8 history taps (a template on their count) live in
 * registers, negated, and with f0 == +-1 the history holds the raw
 * accumulators (only their low 16 bits matter), so the chain from one
 * output to the next is a single multiply-add. Longer filters keep their
 * taps and a lane-minor history ring in shared memory while both fit in
 * the device's opt-in (about 1500 taps on an H100); past it the ring moves
 * to a global scratch (a warp's 32 lanes still read one line a tap) and
 * the taps are read through L1: no filter length is refused. Rows whose length is not a multiple of 8 (or blocks
 * whose L is not), or pointers off a 16-byte boundary, take element-wise
 * staging with the same walk.
 */
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"
#include "smem_check.h"

namespace {

constexpr int kRows = 32;              // virtual rows of a tile: one a lane
constexpr int kSamples = 256;          // samples of a tile
constexpr int kPitch = kSamples + 8;   // int16s per shared row (528 bytes)
constexpr int kTile = kRows * kPitch;  // int16s of one tile buffer
constexpr int kTileBytes = kTile * 2;
constexpr int kHeaderBytes = kRows * 16;  // each lane's start and length
constexpr int kRegTaps = 8;            // history taps kept in registers
constexpr int kState = 8;              // int16s of a block's carried history
constexpr int kAhead = 16;             // pass B: histories loaded ahead

enum Mode { kFinal = 0, kExit = 1 };

bool aligned16(const void *p) { return ((uintptr_t)p & 15u) == 0; }

int optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

/* Shared memory of a serial walk of more than kRegTaps taps apart from the
 * ring: the header and two tile buffers. */
constexpr int kRingFixed = kHeaderBytes + 2 * kTileBytes;

/* True where a long filter's taps and history ring both fit in shared
 * memory; else the ring is global and the taps are read through L1. */
bool ring_shared(int64_t nhist) {
  return kRingFixed + nhist * 4 * (kRows + 1) <= optin_smem();
}

__device__ __forceinline__ void cp_async16(void *to, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(to);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the next tile) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  DR_PERTURB();
  asm volatile("cp.async.wait_group 1;\n" ::);
}

/* The output of a step, in the low 16 bits (the high bits are don't-care:
 * every later use is a product or sum mod 2^16, or a store of the low
 * half). With f0 == +-1 that is the accumulator itself, so the chain from
 * one output to the next is a single multiply-add; otherwise the quotient
 * of the wrapped int16 numerator. */
template <bool kDivide>
__device__ __forceinline__ uint32_t finish(uint32_t acc, int32_t f0) {
  if constexpr (kDivide) {
    const int32_t num = (int32_t)(acc << 16) >> 16;
    return (uint32_t)(f0 != 0 ? num / f0 : -1);
  }
  return acc;
}

/* What a launch walks: d (rows, n) in blocks of len samples, nb a row. */
struct Params {
  const int16_t *d;
  int16_t *out;
  const int16_t *taps;
  int16_t *carry;  // (nb - 1, rows, kState): exit, then entry histories
  uint32_t *ring;  // global history ring of a long filter, or null
  int nhist;
  int32_t f0;
  int64_t rows, n, len, nb, ntiles;
  int stages, vec;
};

/* History of kHist taps in registers; -c[j] multiplies out[i - 1 - j],
 * h[j] holds out[i - 1 - j] (the taps are kept negated so that the chain
 * is an add of products, with no negation on it). */
template <int kHist, bool kDivide>
struct RegWalker {
  uint32_t c[kHist > 0 ? kHist : 1];
  uint32_t h[kHist > 0 ? kHist : 1];

  __device__ void init(const Params &p, uint32_t sgn, DR_SMEM_PTR(uint32_t),
                       int) {
#pragma unroll
    for (int j = 0; j < kHist; ++j) {
      c[j] = 0u - sgn * (uint32_t)(int32_t)p.taps[j];
      h[j] = 0;
    }
  }

  /* Entry history of a block (kState int16s, newest first). */
  __device__ void enter(const int16_t *e) {
    if constexpr (kHist > 0) {
      const uint4 q = *reinterpret_cast<const uint4 *>(e);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < kHist; ++j) h[j] = w[j / 2] >> (16 * (j & 1));
    }
  }

  /* Exit history: the last kHist outputs, newest first, zero past them. */
  __device__ void leave(int16_t *e) const {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kHist; ++j)
      w[j / 2] |= (h[j] & 0xFFFFu) << (16 * (j & 1));
    *reinterpret_cast<uint4 *>(e) = make_uint4(w[0], w[1], w[2], w[3]);
  }

  /* One sample: din in the low 16 bits; returns the output there. */
  __device__ __forceinline__ uint32_t step(uint32_t din, uint32_t sgn,
                                           int32_t f0) {
    uint32_t acc = sgn * din;
    // the newest output last: one multiply-add on the recurrence's chain
#pragma unroll
    for (int j = kHist - 1; j >= 0; --j) acc += c[j] * h[j];
    const uint32_t r = finish<kDivide>(acc, f0);
#pragma unroll
    for (int j = kHist - 1; j > 0; --j) h[j] = h[j - 1];
    if constexpr (kHist > 0) h[0] = r;
    return r;
  }
};

/* Any number of taps: the lane's history a ring of nhist entries at
 * hs[slot * kRows + lane] (lane-minor: no bank conflicts in shared memory,
 * one line a warp in global). kShared: the taps folded into shared memory
 * and the ring after them; else the ring global and the taps read from the
 * tensor through L1, folded at each use. */
template <bool kDivide, bool kShared>
struct RingWalker {
  DR_SMEM_PTR(const uint32_t) cs;
  const int16_t *taps;
  DR_SMEM_PTR_IF(kShared, uint32_t) hs;
  uint32_t sgn;
  int nhist, pos, lane;

  __device__ void init(const Params &p, uint32_t sgn_,
                       DR_SMEM_PTR(uint32_t) shared, int lane_) {
    nhist = p.nhist;
    lane = lane_;
    sgn = sgn_;
    pos = 0;
    taps = p.taps;
    cs = shared;
    if constexpr (kShared) {
      for (int j = lane; j < nhist; j += kRows)
        DR_SM(shared, j) = sgn * (uint32_t)(int32_t)taps[j];
      hs = shared + nhist;
    } else {
      hs = p.ring + (int64_t)blockIdx.x * nhist * kRows;
    }
    for (int j = 0; j < nhist; ++j)
      DR_SM(hs, (int64_t)j * kRows + lane) = 0;
    DR_SYNCWARP();
  }

  __device__ void enter(const int16_t *) {}

  __device__ __forceinline__ uint32_t tap(int j) const {
    if constexpr (kShared) return DR_SM(cs, j);
    return sgn * (uint32_t)(int32_t)__ldg(taps + j);
  }

  __device__ __forceinline__ uint32_t step(uint32_t din, uint32_t,
                                           int32_t f0) {
    uint32_t acc = sgn * din;
    int q = pos;  // the newest output sits one slot before pos
    for (int j = 0; j < nhist; ++j) {
      q = (q == 0 ? nhist : q) - 1;
      acc -= tap(j) * DR_SM(hs, (int64_t)q * kRows + lane);
    }
    const uint32_t r = finish<kDivide>(acc, f0);
    DR_SM(hs, (int64_t)pos * kRows + lane) = r;  // over the oldest
    pos = pos + 1 == nhist ? 0 : pos + 1;
    return r;
  }
};

/* Block x walks virtual rows [32 x, 32 x + 32). kFinal: every block of
 * every row (v = r * nb + b), from its entry history (zero for b == 0),
 * storing the outputs. kExit: the blocks b < nb - 1 (v = r * (nb - 1) +
 * b, all full), from a zero history, storing only the exit history to
 * carry[b, r]. */
template <class W, int kMode>
__device__ __forceinline__ void walk(const Params &p) {
  DR_DYNAMIC_SHARED(smem);
  DR_SMEM_ENTRY_DYNAMIC(smem);
  // each lane's start and length
  DR_SMEM_PTR(longlong2) info =
      DR_SM_CARVE(longlong2, smem, 0, kRows, "info");
  DR_SMEM_PTR(int16_t) tiles = DR_SM_CARVE(int16_t, smem, kHeaderBytes,
                                           p.stages * kTile, "tiles");
  DR_SMEM_PTR(uint32_t) extra = DR_SM_CARVE(
      uint32_t, smem, kHeaderBytes + p.stages * kTileBytes,
      (dr::smem::dynamic_bytes() - kHeaderBytes - p.stages * kTileBytes) / 4,
      "extra");
  const int lane = threadIdx.x;
  const int64_t per_row = kMode == kExit ? p.nb - 1 : p.nb;
  const int64_t v0 = (int64_t)blockIdx.x * kRows;
  const int64_t left_rows = p.rows * per_row - v0;
  const int nv = (int)(left_rows < kRows ? left_rows : kRows);
  const int64_t v = v0 + lane;
  int64_t len = 0, start = 0, slot = -1;
  if (lane < nv) {
    const int64_t r = v / per_row;
    const int64_t b = v - r * per_row;
    const int64_t left = p.n - b * p.len;
    len = left < p.len ? left : p.len;
    start = r * p.n + b * p.len;
    // block b's exit history, block b + 1's entry: carry[b, r]
    if (kMode == kExit) slot = b * p.rows + r;
    if (kMode == kFinal && b > 0) slot = (b - 1) * p.rows + r;
  }
  DR_SM(info, lane) = make_longlong2(start, len);
  // tiles before the warp's shortest row's last are full in every row
  int64_t shortest = lane < nv ? len : INT64_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t other = __shfl_xor_sync(0xFFFFFFFFu, shortest, o);
    shortest = other < shortest ? other : shortest;
  }
  const int64_t full_tiles = shortest / kSamples;
  // f0 == +-1: fold its sign into the input and the taps, divide by nothing
  const uint32_t sgn = (p.f0 == 1 || p.f0 == -1) ? (uint32_t)p.f0 : 1u;
  W walker;
  walker.init(p, sgn, extra, lane);
  if (kMode == kFinal && slot >= 0) walker.enter(p.carry + slot * kState);
  DR_SYNCWARP();  // every lane's start and length are in place

  auto tile_len = [&](int64_t len_rr, int64_t t) {
    const int64_t left = len_rr - t * kSamples;
    return (int)(left < 0 ? 0 : left < kSamples ? left : kSamples);
  };
  auto buffer = [&](int64_t t) {
    return tiles + (p.stages == 2 ? (int)(t & 1) : 0) * kTile;
  };
  // a tile's rows: 16 bytes a lane where every row is full (the rows'
  // starts a broadcast shared load each), else row by row as each allows
  auto load = [&](int64_t t) {
    DR_SMEM_PTR(int16_t) tile = buffer(t) + lane * 8;
    const int16_t *d = p.d + t * kSamples + lane * 8;
    if (p.vec && t < full_tiles) {
#pragma unroll 8
      for (int rr = 0; rr < nv; ++rr)
        cp_async16(DR_SM_SPAN(tile + rr * kPitch, 8),
                   d + DR_SM(info, rr).x);
    } else if (p.vec) {
      for (int rr = 0; rr < nv; ++rr) {
        const longlong2 ri = DR_SM(info, rr);
        if (lane * 8 < tile_len(ri.y, t))
          cp_async16(DR_SM_SPAN(tile + rr * kPitch, 8), d + ri.x);
      }
    } else {
      for (int rr = 0; rr < nv; ++rr) {
        const longlong2 ri = DR_SM(info, rr);
        const int tl = tile_len(ri.y, t);
        const int16_t *src = p.d + ri.x + t * kSamples;
        DR_SMEM_PTR(int16_t) dst = buffer(t) + rr * kPitch;
        for (int i = lane; i < tl; i += kRows) DR_SM(dst, i) = src[i];
      }
    }
    cp_async_commit();
  };

  load(0);
  for (int64_t t = 0; t < p.ntiles; ++t) {
    if (t + 1 < p.ntiles)
      load(t + 1);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_one();
    DR_SYNCWARP();
    DR_SMEM_PTR(int16_t) tile = buffer(t);
    if (lane < nv) {
      // 8 samples a step of the loop; past the row's end (its last tile
      // only, and only where its length is not a multiple of 8) the walk
      // runs on stale values that are never stored: kExit walks full
      // blocks of a multiple of 8 samples only
      const int len_t = tile_len(len, t);
      DR_SMEM_PTR(int16_t) row = tile + lane * kPitch;
      for (int g = 0; g < len_t; g += 8) {
        const uint4 q =
            *reinterpret_cast<const uint4 *>(DR_SM_SPAN(row + g, 8));
        uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t lo = walker.step(w[k] & 0xFFFFu, sgn, p.f0);
          const uint32_t hi = walker.step(w[k] >> 16, sgn, p.f0);
          w[k] = __byte_perm(lo, hi, 0x5410);  // the two low halves
        }
        if (kMode == kFinal)
          *reinterpret_cast<uint4 *>(DR_SM_SPAN(row + g, 8)) =
              make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    DR_SYNCWARP();
    if (kMode == kFinal) {
      int16_t *out = p.out + t * kSamples + lane * 8;
      DR_SMEM_PTR(const int16_t) src = tile + lane * 8;
      if (p.vec && t < full_tiles) {
#pragma unroll 8
        for (int rr = 0; rr < nv; ++rr)
          *reinterpret_cast<uint4 *>(out + DR_SM(info, rr).x) =
              *reinterpret_cast<const uint4 *>(
                  DR_SM_SPAN(src + rr * kPitch, 8));
      } else if (p.vec) {
        for (int rr = 0; rr < nv; ++rr) {
          const longlong2 ri = DR_SM(info, rr);
          if (lane * 8 < tile_len(ri.y, t))
            *reinterpret_cast<uint4 *>(out + ri.x) =
                *reinterpret_cast<const uint4 *>(
                    DR_SM_SPAN(src + rr * kPitch, 8));
        }
      } else {
        for (int rr = 0; rr < nv; ++rr) {
          const longlong2 ri = DR_SM(info, rr);
          const int tl = tile_len(ri.y, t);
          int16_t *dst = p.out + ri.x + t * kSamples;
          for (int i = lane; i < tl; i += kRows)
            dst[i] = DR_SM(tile, rr * kPitch + i);
        }
      }
      DR_SYNCWARP();  // the tile is read out before the load of t + 2
    }
  }
  if constexpr (kMode == kExit) {
    if (lane < nv) walker.leave(p.carry + slot * kState);
  }
}

// pass A of the blocked scan
template <class W>
__global__ void __launch_bounds__(kRows) exit_kernel(Params p) {
  walk<W, kExit>(p);
}

// pass C of the blocked scan, and the serial walk
template <class W>
__global__ void __launch_bounds__(kRows) walk_kernel(Params p) {
  walk<W, kFinal>(p);
}

/* One step of pass B: s = M s + e (e: the 16-byte exit history q);
 * returns s packed as the entry history of the next block. */
template <int kHist>
__device__ __forceinline__ uint4 carry_step(const uint32_t (&m)[kHist][kHist],
                                            uint32_t (&s)[kHist], uint4 q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t ns[kHist];
#pragma unroll
  for (int j = 0; j < kHist; ++j) {
    uint32_t acc = w[j / 2] >> (16 * (j & 1));
#pragma unroll
    for (int k = 0; k < kHist; ++k) acc += m[j][k] * s[k];
    ns[j] = acc;
  }
  uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kHist; ++j) {
    s[j] = ns[j];
    o[j / 2] |= (ns[j] & 0xFFFFu) << (16 * (j & 1));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

/* Pass B: thread r carries row r over its nexit = nb - 1 exit histories
 * in place: s_0 = 0, s_{b+1} = M s_b + e_b, and carry[b, r] becomes
 * s_{b+1}, the entry history of block b + 1. Each history is loaded
 * kAhead steps before the chain needs it, into a ring of registers that
 * the unrolled loop indexes by constants; the load is unconditional (the
 * index clamped) and issued after the step has read the register, so it
 * lands in place and the chain never waits on memory. Pass A has just
 * written the histories, so they come from L2. M is trans (kHist x kHist
 * int16, row-major). */
template <int kHist>
__global__ void __launch_bounds__(kRows)
    carry_kernel(int16_t *carry, const int16_t *__restrict__ trans,
                 int64_t rows, int64_t nexit) {
  const int64_t r = (int64_t)blockIdx.x * kRows + threadIdx.x;
  if (r >= rows) return;
  uint32_t m[kHist][kHist], s[kHist];
#pragma unroll
  for (int j = 0; j < kHist; ++j) {
    s[j] = 0;
#pragma unroll
    for (int k = 0; k < kHist; ++k)
      m[j][k] = (uint32_t)(int32_t)trans[j * kHist + k];
  }
  // row r's history of block b at cell[b * rows]: a warp's 32 rows move
  // 512 contiguous bytes a step
  uint4 *cell = reinterpret_cast<uint4 *>(carry) + r;
  auto at = [&](int64_t b) { return cell + (b < nexit ? b : nexit - 1) * rows; };
  uint4 ahead[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ahead[i] = *at(i);
  int64_t b0 = 0;
  uint4 *here = cell;  // block b0 + i
  const int64_t lead = kAhead * rows;
  for (; b0 + 2 * kAhead <= nexit; b0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const uint4 e = carry_step<kHist>(m, s, ahead[i]);
      ahead[i] = here[lead];
      *here = e;
      here += rows;
    }
  }
  // the last kAhead to 2 kAhead - 1 blocks: loads clamped, stores guarded
  for (; b0 < nexit; b0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (b0 + i < nexit) {
        const uint4 e = carry_step<kHist>(m, s, ahead[i]);
        ahead[i] = *at(b0 + i + kAhead);
        *at(b0 + i) = e;
      }
    }
  }
}

int set_smem(const void *kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

/* Launch a walk over vrows virtual rows; extra: shared bytes past the
 * tiles (a long filter's taps and ring). */
template <class W, int kMode>
int launch_walk(Params p, int64_t vrows, int extra, cudaStream_t s) {
  const int64_t longest = p.len < p.n ? p.len : p.n;
  p.ntiles = (longest + kSamples - 1) / kSamples;
  p.stages = p.ntiles > 1 ? 2 : 1;
  const int smem = kHeaderBytes + p.stages * kTileBytes + extra;
  void (*kernel)(Params);
  if constexpr (kMode == kExit)
    kernel = exit_kernel<W>;
  else
    kernel = walk_kernel<W>;
  const int rc = set_smem((const void *)kernel, smem);
  if (rc != 0) return rc;
  const int64_t blocks = (vrows + kRows - 1) / kRows;
  kernel<<<(unsigned)blocks, kRows, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int kHist>
int launch_carry(const Params &p, const int16_t *trans, cudaStream_t s) {
  auto *kernel = carry_kernel<kHist>;
  const int64_t blocks = (p.rows + kRows - 1) / kRows;
  kernel<<<(unsigned)blocks, kRows, 0, s>>>(p.carry, trans, p.rows, p.nb - 1);
  return (int)cudaGetLastError();
}

template <int kHist>
int blocked(const Params &p, const int16_t *trans, cudaStream_t s) {
  using W = RegWalker<kHist, false>;
  int rc = 0;
  if constexpr (kHist > 0) {  // a walk without history carries nothing
    if (p.nb > 1) rc = launch_walk<W, kExit>(p, p.rows * (p.nb - 1), 0, s);
    if (p.nb > 1 && rc == 0) rc = launch_carry<kHist>(p, trans, s);
  }
  if (rc == 0) rc = launch_walk<W, kFinal>(p, p.rows * p.nb, 0, s);
  return rc;
}

template <bool kDivide>
int serial(const Params &p, cudaStream_t s) {
  static_assert(kRegTaps == 8, "one case per register history length");
  switch (p.nhist) {
#define DR_IIR_REG(k) \
  case k:             \
    return launch_walk<RegWalker<k, kDivide>, kFinal>(p, p.rows, 0, s);
    DR_IIR_REG(0) DR_IIR_REG(1) DR_IIR_REG(2) DR_IIR_REG(3) DR_IIR_REG(4)
    DR_IIR_REG(5) DR_IIR_REG(6) DR_IIR_REG(7) DR_IIR_REG(8)
#undef DR_IIR_REG
    default:
      break;
  }
  if (ring_shared(p.nhist)) {
    if (p.ring) return (int)cudaErrorInvalidValue;
    return launch_walk<RingWalker<kDivide, true>, kFinal>(
        p, p.rows, (int)((int64_t)p.nhist * 4 * (kRows + 1)), s);
  }
  if (!p.ring) return (int)cudaErrorInvalidValue;
  return launch_walk<RingWalker<kDivide, false>, kFinal>(p, p.rows, 0, s);
}

bool shape_ok(int64_t rows, int64_t n, int64_t nhist, int64_t vrows) {
  return rows >= 0 && n >= 0 && nhist >= 0 && nhist < ((int64_t)1 << 31) &&
         (vrows + kRows - 1) / kRows < ((int64_t)1 << 31);
}

}  // namespace

extern "C" int64_t dr_iir_ring_bytes(int64_t nhist, int64_t rows) {
  if (nhist <= kRegTaps || rows <= 0 || ring_shared(nhist)) return 0;
  return (rows + kRows - 1) / kRows * nhist * kRows * 4;
}

extern "C" int dr_iir_decode(const int16_t *d, int16_t *out,
                             const int16_t *taps, int64_t nhist, int f0,
                             int64_t rows, int64_t n, void *ring,
                             void *stream) {
  if (!shape_ok(rows, n, nhist, rows)) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  Params p{};
  p.d = d;
  p.out = out;
  p.taps = taps;
  p.ring = static_cast<uint32_t *>(ring);
  p.nhist = (int)nhist;
  p.f0 = (int16_t)f0;
  p.rows = rows;
  p.n = n;
  p.len = n;
  p.nb = 1;
  p.vec = n % 8 == 0 && aligned16(d) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.f0 == 1 || p.f0 == -1) return serial<false>(p, s);
  return serial<true>(p, s);
}

extern "C" int dr_iir_blocked(const int16_t *d, int16_t *out,
                              const int16_t *taps, const int16_t *trans,
                              int16_t *carry, int64_t nhist, int f0,
                              int64_t rows, int64_t n, int64_t block,
                              void *stream) {
  const int32_t f = (int16_t)f0;
  if (block < 8 || block % 8 != 0 || nhist > kRegTaps || (f != 1 && f != -1))
    return (int)cudaErrorInvalidValue;
  const int64_t nb = n > 0 ? (n + block - 1) / block : 1;
  if (!shape_ok(rows, n, nhist, rows * nb)) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  if (nhist > 0 && nb > 1 && (!carry || !trans || !aligned16(carry)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.d = d;
  p.out = out;
  p.taps = taps;
  p.carry = carry;
  p.nhist = (int)nhist;
  p.f0 = f;
  p.rows = rows;
  p.n = n;
  p.len = block;
  p.nb = nb;
  p.vec = n % 8 == 0 && aligned16(d) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nhist) {
    case 0: return blocked<0>(p, trans, s);
    case 1: return blocked<1>(p, trans, s);
    case 2: return blocked<2>(p, trans, s);
    case 3: return blocked<3>(p, trans, s);
    case 4: return blocked<4>(p, trans, s);
    case 5: return blocked<5>(p, trans, s);
    case 6: return blocked<6>(p, trans, s);
    case 7: return blocked<7>(p, trans, s);
    default: return blocked<8>(p, trans, s);
  }
}

/* The generic forward pre-filter: every filter but the delta, which B1
 * fuses. Replaces the int64 torch passes of ops/prefilter.py (the plain
 * version, prefilter_encode_plain, which a CPU tensor takes) and, in the
 * JAX package, deltarice_tpu/ops/prefilter.py::prefilter_encode, which is
 * no Pallas kernel but int16 jnp ops that XLA fuses. Per row of len
 * samples:
 *
 *   out[i] = wrap16(sum_{j <= min(i, ntaps - 1)} c16(taps[j]) * x[i - j]).
 *
 * The reference accumulates into a C short; products and sums run here in
 * uint32 (mod 2^32, which agrees mod 2^16), with each sample's low 16 bits
 * the only ones that matter, so nothing is widened past 32 bits.
 *
 * Bound: device-memory bytes, each sample read once and written once (4
 * bytes a sample). The leading axes are flattened: the input is n = rows
 * * len samples, cut into vectors of 8 (16 bytes) on that flat grid, so
 * the loads and stores do not depend on len, and a sample's row position
 * is e mod len. A block of kFirThreads threads owns kFirBlockVecs vectors
 * (8192 samples, each thread kFirVecs of them, kFirThreads apart so that
 * a warp's accesses are contiguous).
 *
 * Two forms by the filter's length, picked in dr_fir_encode:
 *   kTaps in 1..kFirRegTaps (the filters users run: the optimizer's are a
 *     few taps): the taps in registers and every loop unrolled. The block
 *     stages its vectors, with the one vector before them (the halo; zero
 *     before the input's start), in shared memory, all of a thread's loads
 *     in flight at once; after one barrier each thread computes its 8
 *     outputs a vector and stores them as one 16-byte store. A tap that
 *     reaches past its row's start is masked; a vector that no row starts
 *     in or just before (every vector but about one a row) takes the
 *     unmasked sum.
 *   kTaps == -1, any longer filter: no staging; each sample's history and
 *     the taps are read from global memory through L1. Exact at every
 *     length, and not tuned.
 * Vectors whose pointer is off a 16-byte boundary, and the last vector of
 * an input whose n is not a multiple of 8, move element by element (the
 * same vectors, the same arithmetic): an input off 16 bytes moves every
 * vector so. */
namespace {

constexpr int kFirThreads = 256;
constexpr int kFirVecs = 4;  // vectors a thread
constexpr int kFirBlockVecs = kFirThreads * kFirVecs;
constexpr int kFirRegTaps = 8;  // taps kept in registers, unrolled

struct FirParams {
  const int16_t *x;
  int16_t *out;
  const int16_t *taps;  // ntaps int16s on the device
  int64_t n, len;       // samples in all, samples a row
  int ntaps, hvec;      // taps, halo vectors
  bool vx, vo;          // x, out 16-byte aligned
};

// e mod len, in 32 bits where both fit
__device__ __forceinline__ int64_t row_pos(int64_t e, int64_t len) {
  if ((((uint64_t)e | (uint64_t)len) >> 32) == 0)
    return (uint32_t)e % (uint32_t)len;
  return e % len;
}

// vector v of x (samples 8 v to 8 v + 7), zero outside [0, n)
__device__ __forceinline__ uint4 fir_load(const FirParams &p, int64_t v) {
  const int64_t e = 8 * v;
  if (p.vx && e >= 0 && e + 8 <= p.n)
    return __ldg(reinterpret_cast<const uint4 *>(p.x) + v);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (e + k >= 0 && e + k < p.n)
      w[k / 2] |= (uint32_t)(uint16_t)p.x[e + k] << (16 * (k & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the low halves of o as vector v of out, nothing past n
__device__ __forceinline__ void fir_store(const FirParams &p, int64_t v,
                                          const uint32_t (&o)[8]) {
  const int64_t e = 8 * v;
  if (p.vo && e + 8 <= p.n) {
    *reinterpret_cast<uint4 *>(p.out + e) =
        make_uint4(__byte_perm(o[0], o[1], 0x5410),
                   __byte_perm(o[2], o[3], 0x5410),
                   __byte_perm(o[4], o[5], 0x5410),
                   __byte_perm(o[6], o[7], 0x5410));
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (e + k < p.n) p.out[e + k] = (int16_t)o[k];
}

/* Block x computes vectors [kFirBlockVecs x, kFirBlockVecs (x + 1)). */
template <int kTaps>
__global__ void __launch_bounds__(kFirThreads) fir_kernel(FirParams p) {
  DR_DYNAMIC_SHARED(smem);
  DR_SMEM_ENTRY_DYNAMIC(smem);
  constexpr bool kStaged = kTaps > 0;
  const int nwin = kStaged ? p.hvec + kFirBlockVecs : 0;
  // the window: vector i is vector v0 - hvec + i of x
  DR_SMEM_PTR(uint4) win = DR_SM_CARVE(uint4, smem, 0, nwin, "win");
  const int t = threadIdx.x;
  const int64_t v0 = (int64_t)blockIdx.x * kFirBlockVecs;
  uint32_t c[kStaged ? kTaps : 1];
  if constexpr (kStaged) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) c[j] = (uint16_t)__ldg(p.taps + j);
    uint4 q[kFirVecs];
#pragma unroll
    for (int r = 0; r < kFirVecs; ++r)
      q[r] = fir_load(p, v0 + t + r * kFirThreads);
    for (int i = t; i < p.hvec; i += kFirThreads)
      DR_SM(win, i) = fir_load(p, v0 - p.hvec + i);
#pragma unroll
    for (int r = 0; r < kFirVecs; ++r)
      DR_SM(win, p.hvec + t + r * kFirThreads) = q[r];
    DR_SYNCTHREADS();
  }
#pragma unroll
  for (int r = 0; r < kFirVecs; ++r) {
    const int local = t + r * kFirThreads;
    const int64_t v = v0 + local;
    if (8 * v >= p.n) break;
    const int64_t pos = row_pos(8 * v, p.len);  // of the vector's first
    uint32_t o[8];
    if constexpr (kStaged) {
      // s[kBack + k] is sample 8 v + k; the low halves carry garbage above
      // bit 15, which no product or sum mod 2^16 sees
      constexpr int kHv = (kTaps + 6) / 8;
      constexpr int kBack = 8 * kHv;
      uint32_t s[kBack + 8];
#pragma unroll
      for (int i = 0; i <= kHv; ++i) {
        const uint4 w = DR_SM(win, local + i);  // hvec == kHv
        const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          s[8 * i + 2 * m] = h[m];
          s[8 * i + 2 * m + 1] = h[m] >> 16;
        }
      }
      if (pos >= kTaps - 1 && pos + 7 < p.len) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint32_t acc = 0;
#pragma unroll
          for (int j = 0; j < kTaps; ++j) acc += c[j] * s[kBack + k - j];
          o[k] = acc;
        }
      } else {  // a row starts in or just before the vector
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int64_t pk = row_pos(pos + k, p.len);
          uint32_t acc = 0;
#pragma unroll
          for (int j = 0; j < kTaps; ++j)
            if (j <= pk) acc += c[j] * s[kBack + k - j];
          o[k] = acc;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t e = 8 * v + k;
        const int64_t pk = row_pos(pos + k, p.len);
        const int64_t jmax = pk < p.ntaps - 1 ? pk : p.ntaps - 1;
        uint32_t acc = 0;
        if (e < p.n) {
          for (int64_t j = 0; j <= jmax; ++j)
            acc += (uint32_t)(uint16_t)__ldg(p.taps + j) *
                   (uint32_t)(uint16_t)__ldg(p.x + e - j);
        }
        o[k] = acc;
      }
    }
    fir_store(p, v, o);
  }
}

template <int kTaps>
int fir_launch(const FirParams &p, int smem, cudaStream_t s) {
  const int rc = set_smem((const void *)fir_kernel<kTaps>, smem);
  if (rc != 0) return rc;
  const int64_t blocks = ((p.n + 7) / 8 + kFirBlockVecs - 1) / kFirBlockVecs;
  fir_kernel<kTaps><<<(unsigned)blocks, kFirThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dr_fir_encode(const int16_t *x, int16_t *out,
                             const int16_t *taps, int64_t ntaps, int64_t n,
                             int64_t len, void *stream) {
  if (ntaps < 1 || ntaps >= ((int64_t)1 << 30) || n < 0 || len < 1 ||
      (n + 7) / 8 / kFirBlockVecs >= ((int64_t)1 << 31) - 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  FirParams p{};
  p.x = x;
  p.out = out;
  p.taps = taps;
  p.n = n;
  p.len = len;
  p.ntaps = (int)ntaps;
  p.hvec = (int)((ntaps - 1 + 7) / 8);
  p.vx = aligned16(x);
  p.vo = aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t win = ((int64_t)p.hvec + kFirBlockVecs) * 16;
  static_assert(kFirRegTaps == 8, "one case per register tap count");
  switch (ntaps) {
#define DR_FIR_REG(k) \
  case k:             \
    return fir_launch<k>(p, (int)win, s);
    DR_FIR_REG(1) DR_FIR_REG(2) DR_FIR_REG(3) DR_FIR_REG(4) DR_FIR_REG(5)
    DR_FIR_REG(6) DR_FIR_REG(7) DR_FIR_REG(8)
#undef DR_FIR_REG
    default:
      return fir_launch<-1>(p, 0, s);
  }
}
