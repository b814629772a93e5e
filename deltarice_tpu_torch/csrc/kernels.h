/* Plain C interface of the port's CUDA kernels (bound with ctypes by
 * deltarice_tpu_torch/ops/_kernels.py).
 *
 * Every entry point launches on the given stream, does not synchronise and
 * allocates nothing: the caller passes device pointers to tensors it
 * allocated (outputs that must start zeroed are zeroed by the caller). Each
 * returns cudaGetLastError() after its launch, 0 on success.
 *
 * Layouts are row-major. The codec kernels B1, B2 and B9 take
 * segment-major arrays ((nseg, L) samples, (nseg, W) words), as the codec
 * holds them.
 */
#ifndef DR_KERNELS_H
#define DR_KERNELS_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* out (n, b, a) = x (n, a, b), each matrix transposed; elem_size is 2 or
 * 4 bytes (else cudaErrorInvalidValue). 16 bytes a thread both ways where
 * a and b are multiples of 16 / elem_size and both pointers are 16-byte
 * aligned, else one element at a time. */
int dr_transpose2d(const void *x, void *out, int64_t n, int64_t a, int64_t b,
                   int elem_size, void *stream);

/* 1 where dr_transpose2d takes its 16-byte path for these pointers and
 * shape, else 0 (the element-wise path). */
int dr_transpose_vector_path(const void *x, const void *out, int64_t a,
                             int64_t b, int elem_size);

/* The transpose's tiles for elem_size: geometry[0..8] = threads of a
 * block, warps along A, threads of a warp along A, along B, 16-byte pieces
 * of a shared tile row, vector tile rows (along A), its columns (along
 * B), the element-wise tile's edge and its rows of threads. Returns 0. */
int dr_transpose_geometry(int elem_size, int64_t *geometry);

/* Fused delta (diff != 0, seeded by prev0[s], which may be NULL for 0) +
 * zigzag + Rice code + MSB-first pack of row s of x (nseg, length) int16,
 * samples at or past nvalid[s] left out. Word n of segment s goes to
 * words[s * cap + n] while n < cap (the caller zeroes words); nwords /
 * nbits are exact regardless of cap. scratch holds
 * dr_pack_scratch_words(length, nseg) int32s. */
int64_t dr_pack_scratch_words(int64_t length, int64_t nseg);
int dr_pack_encode(const int16_t *x, const int32_t *nvalid,
                   const int32_t *prev0, int32_t *words, int32_t *nwords,
                   int32_t *nbits, int32_t *scratch, int64_t length,
                   int64_t nseg, int64_t cap, int k, int diff, void *stream);

/* Rice decode of row s of words (nseg, w) (uint32 bit patterns, at least
 * one zero pad word past each stream) into n_samples samples at
 * out[s * n_samples + i] (out 8-byte aligned); with delta the wrapping
 * int16 prefix sum is fused in, otherwise the un-zigzagged values are
 * stored. The cursor is clamped at bit 32 * (w - 1), as the serial decode
 * clamps it. scratch holds dr_unpack_scratch_bytes(w, nseg) bytes.
 * rejoined (NULL or a device counter) gains the tiles that the first
 * pass's check walked again. Afterwards the scratch starts with one entry
 * per tile t of segment s, at [(s * ntiles + t) * 2 + 0] = codewords
 * starting in the tile and [.. + 1] = (their wrapping int16 sum << 16) |
 * entry phase walked from << 8 | exit phase, ntiles = ceil((w - 1) / 32):
 * from the tile's true entry phase wherever its first codeword lies below
 * n_samples. */
int64_t dr_unpack_scratch_bytes(int64_t w, int64_t nseg);
int dr_unpack_decode(const int32_t *words, int16_t *out, void *scratch,
                     int64_t scratch_bytes, int64_t w, int64_t nseg,
                     int64_t n_samples, int k, int delta,
                     unsigned long long *rejoined, void *stream);

/* Every tile's walk from each entry phase, the oracle of the first pass:
 * for tile t (32 words) of segment s and entry
 * phase e (0..24), tab[((s * ntiles + t) * 25 + e) * 2 + 0] = codewords
 * starting in the tile and [.. + 1] = (their wrapping int16 sum << 16) |
 * exit phase, ntiles = ceil((w - 1) / 32). */
int dr_unpack_tables(const int32_t *words, int32_t *tab, int64_t w,
                     int64_t nseg, int k, void *stream);

/* Concentrate "sorted with gaps" rows: lead (rows, r) int32 holds
 * disp << 16 | high-or-only halfword for live slots (0 <= disp < 2^15) and
 * INT32_MIN for dead ones; follow (rows, r) int16 (may be NULL) carries the
 * low halfword. Live slot j of row i lands at out[i, j - disp] (out (rows,
 * n_out) int32, zeroed by the caller): (hi << 16) | lo with a follower,
 * else the halfword. */
int dr_concentrate_packed(const int32_t *lead, const int16_t *follow,
                          int32_t *out, int64_t rows, int64_t r,
                          int64_t n_out, void *stream);

/* Two-plane concentration, any slot axis and displacement: live slot j of
 * row i (disp[i, j] >= 0) stores values[i, j] at out[i, j - disp[i, j]]
 * (out (rows, n_out) int32, zeroed by the caller; stores past n_out are
 * dropped). */
int dr_concentrate_wide(const int32_t *values, const int32_t *disp,
                        int32_t *out, int64_t rows, int64_t r, int64_t n_out,
                        void *stream);

/* One-plane concentration of ((disp << 16) | halfword) ^ 2^31 (dead =
 * INT32_MIN): the halfword of live slot j lands at out[i, j - disp],
 * zero-extended (out zeroed by the caller). */
int dr_concentrate_wide16(const int32_t *plane, int32_t *out, int64_t rows,
                          int64_t r, int64_t n_out, void *stream);

/* Concentration in the tiled layout (blocks, rows_in, lanes), row
 * slot * sb + s holding slot `slot` of row (b, s, lane). mode 0: lead is
 * disp << 16 | halfword (dead INT32_MIN, disp < 2^15), follow (may be NULL)
 * the low halfword; mode 1: lead is ((disp << 16) | halfword) ^ 2^31 (dead
 * INT32_MIN, follow NULL). Live slot j lands at slot j - disp of out
 * (blocks, rows_out, lanes), every element written: int16 halfwords, or
 * with emit_u32 int32 words (hi << 16 | lo with a follower, else the
 * halfword zero-extended); slots nothing reaches are 0, destinations at or
 * past rows_out / sb are dropped. work: the caller's scratch, 16-byte
 * aligned, blocks * sb * lanes * work stride elements of out's type (the
 * stride: rows_out / sb padded to an odd number of 64s). The planes are
 * read 16 bytes at a time where sb * lanes is a multiple of 8 and both
 * start on a 16-byte boundary, else one element at a time. rows_in * lanes,
 * rows_out * lanes and the scratch of one block below 2^31; blocks at most
 * 65535, else cudaErrorInvalidValue. */
int dr_concentrate_tiled(const int32_t *lead, const int16_t *follow,
                         void *out, int64_t blocks, int64_t rows_in,
                         int64_t lanes, int64_t rows_out, int64_t sb, int mode,
                         int emit_u32, void *work, void *stream);

/* The same layout with explicit planes: values int16, disp int32 (>= 0
 * live, negative dead), out int16 (blocks, rows_out, lanes), work and the
 * loads as above. */
int dr_concentrate_tiled_vd(const int16_t *values, const int32_t *disp,
                            int16_t *out, int64_t blocks, int64_t rows_in,
                            int64_t lanes, int64_t rows_out, int64_t sb,
                            void *work, void *stream);

/* Speculative split decode of words (nseg, w) into nseg * parts
 * sub-blocks of wsub words, each warmed up over halo words: row
 * s * parts + p stores its samples at local[row, n] (n < lw; local
 * (rows, lw) int16, zero past the row's count) and its entry phase, exit
 * phase, local count and final delta state at meta[0..3][row]. wv
 * (rows,) is each row's owned word count. passes = 4 runs the kernel
 * whole; 1..3 stop after staging, pass A or pass B (only meta is written,
 * and it is not the result): for timing the passes. */
int dr_split_decode(const int32_t *words, const int32_t *wv, int16_t *local,
                    int32_t *meta, int64_t w, int64_t nseg, int64_t parts,
                    int64_t wsub, int64_t halo, int64_t lw, int k, int delta,
                    int passes, void *stream);

/* The generic pre-filter inverse of each row of d (rows, n) int16 into
 * out (rows, n): out[i] = wrap16(d[i] - sum_{j=1..nhist} taps[j - 1] *
 * out[i - j]) / f0, truncating, wrapped to int16; f0 is taken mod 2^16
 * (0 gives -1 everywhere, XLA's division by zero; +-1 divides by
 * nothing). taps: nhist int16s on the device (may be NULL when nhist is
 * 0); any nhist. Nothing is launched when rows or n is 0.
 *
 * dr_iir_decode walks each row serially, one thread a row. A filter of
 * more than 8 history taps whose ring does not fit in the device's shared
 * memory needs ring: dr_iir_ring_bytes(nhist, rows) bytes on the device
 * (NULL when that is 0), else cudaErrorInvalidValue.
 *
 * dr_iir_blocked, for f0 == +-1 mod 2^16 and nhist <= 8 only: the blocked
 * scan, rows cut into blocks of `block` samples (a multiple of 8). trans:
 * the nhist x nhist int16 transition of a block (row-major, the sign of f0
 * folded into the taps; ops/prefilter_model.py::block_transition); carry:
 * (ceil(n / block) - 1, rows, 8) int16 scratch, 16-byte aligned. Both may
 * be NULL when n <= block or nhist == 0 (one walk). Launches pass A
 * (exit_kernel, exit histories), B (carry_kernel, the carry scan) and C
 * (walk_kernel, the final walk); A and B only where a row has more than
 * one block and the filter a history. */
int64_t dr_iir_ring_bytes(int64_t nhist, int64_t rows);
int dr_iir_decode(const int16_t *d, int16_t *out, const int16_t *taps,
                  int64_t nhist, int f0, int64_t rows, int64_t n, void *ring,
                  void *stream);
int dr_iir_blocked(const int16_t *d, int16_t *out, const int16_t *taps,
                   const int16_t *trans, int16_t *carry, int64_t nhist,
                   int f0, int64_t rows, int64_t n, int64_t block,
                   void *stream);

/* The generic forward pre-filter of x, n int16 samples in rows of len, into
 * out (n): out[i] = wrap16(sum_{j <= min(i mod len, ntaps - 1)} taps[j] *
 * x[i - j]), each tap taken mod 2^16. taps: ntaps int16s on the device;
 * any ntaps >= 1. Either pointer may be off a 16-byte boundary (those
 * vectors move element by element). Nothing is launched when n is 0. */
int dr_fir_encode(const int16_t *x, int16_t *out, const int16_t *taps,
                  int64_t ntaps, int64_t n, int64_t len, void *stream);

#ifdef __cplusplus
}
#endif

#endif /* DR_KERNELS_H */
