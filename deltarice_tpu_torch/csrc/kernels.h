/* Plain C interface of the port's CUDA kernels (bound with ctypes by
 * deltarice_tpu_torch/ops/_kernels.py).
 *
 * Every entry point launches on the given stream, does not synchronise and
 * allocates nothing: the caller passes device pointers to tensors it
 * allocated (outputs that must start zeroed are zeroed by the caller). Each
 * returns cudaGetLastError() after its launch, 0 on success.
 *
 * Layouts are row-major. The codec kernels run one thread per segment and
 * take sample-major / word-major arrays ((L, nseg), (W, nseg)) so that
 * neighbouring threads touch neighbouring addresses; dr_transpose2d converts
 * at the boundary.
 */
#ifndef DR_KERNELS_H
#define DR_KERNELS_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* out (b, a) = x (a, b) transposed; elem_size is 2 or 4 bytes. */
int dr_transpose2d(const void *x, void *out, int64_t a, int64_t b,
                   int elem_size, void *stream);

/* Fused delta (diff != 0, seeded by prev0[s], which may be NULL for 0) +
 * zigzag + Rice code + MSB-first pack of column s of xt (length, nseg)
 * int16. Word n of segment s goes to words_t[n * nseg + s] while n < cap
 * (caller zeroes words_t); nwords / nbits are exact regardless of cap. */
int dr_pack_encode(const int16_t *xt, const int32_t *nvalid,
                   const int32_t *prev0, int32_t *words_t, int32_t *nwords,
                   int32_t *nbits, int64_t length, int64_t nseg, int64_t cap,
                   int k, int diff, void *stream);

/* Rice decode of column s of words_t (w, nseg) (uint32 bit patterns, at
 * least one zero pad word past each stream) into n_samples samples at
 * out_t[i * nseg + s]; with delta the wrapping int16 prefix sum is fused in,
 * otherwise the un-zigzagged values are stored. */
int dr_unpack_decode(const int32_t *words_t, int16_t *out_t, int64_t w,
                     int64_t nseg, int64_t n_samples, int k, int delta,
                     void *stream);

/* Concentrate "sorted with gaps" rows: lead (rows, r) int32 holds
 * disp << 16 | high-or-only halfword for live slots (0 <= disp < 2^15) and
 * INT32_MIN for dead ones; follow (rows, r) int16 (may be NULL) carries the
 * low halfword. Live slot j of row i lands at out[i, j - disp] (out (rows,
 * n_out) int32, zeroed by the caller): (hi << 16) | lo with a follower,
 * else the halfword. */
int dr_concentrate_packed(const int32_t *lead, const int16_t *follow,
                          int32_t *out, int64_t rows, int64_t r,
                          int64_t n_out, void *stream);

#ifdef __cplusplus
}
#endif

#endif /* DR_KERNELS_H */
