/* B3: packed concentration ("sorted with gaps" -> dense) as a scatter.
 *
 * Replaces deltarice_tpu/ops/concentrate_pallas.py::_conc_kernel (driven by
 * _run and concentrate_packed). A TPU vector unit cannot store to a
 * per-lane address, so the TPU compacts each row with a Nassimi-Sahni
 * butterfly: log2(R) shift-and-select passes over the row held in VMEM.
 * A GPU thread can store anywhere, so each live slot j simply writes its
 * payload to j - disp. Destinations are distinct and increase with j, so
 * no two stores conflict and no ordering or atomics are needed; slots that
 * nothing reaches keep the zero the caller filled.
 *
 * Input planes follow the TPU contract: an int32 leader
 * disp << 16 | halfword with dead slots INT32_MIN (disp < 2^15, so live
 * leaders are non-negative), and an optional int16 follower carrying the
 * low halfword of a 32-bit payload.
 *
 * Bound: device-memory bandwidth — one read of each plane and one store
 * per live slot. The grid covers (row, tile of kTile slots), so a few
 * hundred rows (the nEDM merge's window) still fill every SM. Each warp
 * takes 256 consecutive slots: every lane loads 8 consecutive slots with
 * 16-byte loads (two of the leader, one of the follower) where the rows
 * are 16-byte aligned, the warp passes them through shared memory, and
 * the stores go out slot i*32 + lane at step i, so where destinations are
 * dense (the merge) a warp's stores fill consecutive words of the output
 * row instead of one word every 32 bytes.
 */
#include <cuda_runtime.h>
#include <limits.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;                   // slots each lane loads
constexpr int kWarpSlots = 32 * kSlots;     // slots per warp
constexpr int kTile = kThreads * kSlots;    // slots per block
constexpr int kWarps = kThreads / 32;
constexpr int32_t kDead = INT32_MIN;

/* Row blockIdx.x, slots [blockIdx.y * kTile, + kTile). kVec: rows are
 * 16-byte aligned in both planes (r % 8 == 0, aligned bases). */
template <bool kWide, bool kVec>
__global__ void __launch_bounds__(kThreads)
    concentrate_kernel(const int32_t *__restrict__ lead,
                       const int16_t *__restrict__ follow,
                       uint32_t *__restrict__ out, int64_t r, int64_t n_out) {
  __shared__ int4 s_lead[kWarps][kWarpSlots / 4];
  __shared__ uint4 s_follow[kWarps][kWide ? kWarpSlots / 8 : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x;
  const int64_t w0 = (int64_t)blockIdx.y * kTile + warp * kWarpSlots;
  if (w0 >= r) return;  // the whole warp leaves
  const int32_t *lrow = lead + row * r + w0;
  const int16_t *frow = kWide ? follow + row * r + w0 : nullptr;
  int32_t *sl = reinterpret_cast<int32_t *>(s_lead[warp]);
  uint16_t *sf = reinterpret_cast<uint16_t *>(s_follow[warp]);
  if (kVec && w0 + kWarpSlots <= r) {
    const int4 *l4 = reinterpret_cast<const int4 *>(lrow);
    s_lead[warp][2 * lane] = __ldg(l4 + 2 * lane);
    s_lead[warp][2 * lane + 1] = __ldg(l4 + 2 * lane + 1);
    if (kWide)
      s_follow[warp][lane] =
          __ldg(reinterpret_cast<const uint4 *>(frow) + lane);
  } else {  // the ragged end, or unaligned rows: coalesced 4-byte loads
    for (int t = lane; t < kWarpSlots; t += 32) {
      const bool in = w0 + t < r;
      sl[t] = in ? __ldg(lrow + t) : kDead;
      if (kWide) sf[t] = in ? (uint16_t)__ldg(frow + t) : 0;
    }
  }
  __syncwarp();
  uint32_t *orow = out + row * n_out;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int t = i * 32 + lane;
    const int32_t v = sl[t];
    if (v == kDead) continue;
    const int64_t dest = w0 + t - (int64_t)(v >> 16);
    if (dest < 0 || dest >= n_out) continue;
    const uint32_t half = (uint32_t)v & 0xFFFFu;
    orow[dest] = kWide ? (half << 16) | sf[t] : half;
  }
}

template <bool kWide, bool kVec>
void launch(const int32_t *lead, const int16_t *follow, int32_t *out,
            int64_t rows, int64_t r, int64_t n_out, cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (unsigned)((r + kTile - 1) / kTile));
  concentrate_kernel<kWide, kVec><<<grid, kThreads, 0, stream>>>(
      lead, follow, (uint32_t *)out, r, n_out);
}

bool aligned16(const void *p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int dr_concentrate_packed(const int32_t *lead,
                                     const int16_t *follow, int32_t *out,
                                     int64_t rows, int64_t r, int64_t n_out,
                                     void *stream) {
  if (rows <= 0 || r <= 0 || n_out <= 0) return (int)cudaSuccess;
  if (rows > INT_MAX || (r + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = r % kSlots == 0 && aligned16(lead) &&
                   (follow == nullptr || aligned16(follow));
  if (follow != nullptr) {
    if (vec)
      launch<true, true>(lead, follow, out, rows, r, n_out, st);
    else
      launch<true, false>(lead, follow, out, rows, r, n_out, st);
  } else {
    if (vec)
      launch<false, true>(lead, follow, out, rows, r, n_out, st);
    else
      launch<false, false>(lead, follow, out, rows, r, n_out, st);
  }
  return (int)cudaGetLastError();
}
