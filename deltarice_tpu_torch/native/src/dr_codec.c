/* Delta-Rice chunk codec — see dr_codec.h for the design notes. */

#include "dr_codec.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Portable 32-bit leading-zero count: GCC/Clang builtin, MSVC intrinsic
 * (the build matrix includes a cl.exe path — native/build.py). Callers
 * guarantee a nonzero argument. */
#if defined(_MSC_VER) && !defined(__clang__)
#include <intrin.h>
static __forceinline unsigned dr_clz32(uint32_t x) {
  unsigned long idx;
  _BitScanReverse(&idx, x);
  return 31u - (unsigned)idx;
}
#else
#define dr_clz32(x) ((unsigned)__builtin_clz(x))
#endif

#if defined(_OPENMP)
#include <omp.h>
#endif

/* ------------------------------------------------------------------ */
/* configuration                                                      */
/* ------------------------------------------------------------------ */

int dr_config_parse(size_t cd_nelmts, const unsigned *cd_values,
                    dr_config *cfg) {
  cfg->m = 8;
  cfg->seg_len = -1;
  cfg->filt = NULL;
  cfg->filt_len = 0;
  if (cd_nelmts >= 1) cfg->m = cd_values[0];
  if (cd_nelmts >= 2) cfg->seg_len = (int32_t)cd_values[1];
  if (cfg->m == 0 || (cfg->m & (cfg->m - 1)) != 0) {
    fprintf(stderr, "deltarice_tpu: M=%u is not a power of two\n", cfg->m);
    return -1;
  }
  if (cfg->m > (1u << 15)) {
    /* same cap as the Python RiceConfig: larger M cannot round-trip
     * 16-bit zigzag values and the reference silently corrupts it */
    fprintf(stderr, "deltarice_tpu: M=%u exceeds 2^15\n", cfg->m);
    return -1;
  }
  cfg->k = 0;
  for (uint32_t v = cfg->m; v > 1; v >>= 1) cfg->k++;
  if (cd_nelmts >= 3) {
    size_t nf = cd_values[2];
    if (nf == 0 || cd_nelmts < 3 + nf) {
      fprintf(stderr, "deltarice_tpu: bad filter spec in cd_values\n");
      return -1;
    }
    cfg->filt = (int32_t *)malloc(nf * sizeof(int32_t));
    if (!cfg->filt) return -1;
    for (size_t i = 0; i < nf; i++) cfg->filt[i] = (int32_t)cd_values[3 + i];
    cfg->filt_len = nf;
  } else {
    cfg->filt = (int32_t *)malloc(2 * sizeof(int32_t));
    if (!cfg->filt) return -1;
    cfg->filt[0] = 1;
    cfg->filt[1] = -1;
    cfg->filt_len = 2;
  }
  return 0;
}

void dr_config_free(dr_config *cfg) {
  free(cfg->filt);
  cfg->filt = NULL;
}

static int is_delta(const dr_config *cfg) {
  return cfg->filt_len == 2 && cfg->filt[0] == 1 && cfg->filt[1] == -1;
}

/* ------------------------------------------------------------------ */
/* pre-filter (wrapping int16 arithmetic)                             */
/* ------------------------------------------------------------------ */

static void prefilter_invert(int16_t *d, size_t n, const dr_config *cfg) {
  if (is_delta(cfg)) {
    int16_t run = 0;
    for (size_t i = 0; i < n; i++) {
      run = (int16_t)(run + d[i]);
      d[i] = run;
    }
    return;
  }
  /* generic IIR inverse, truncating division by filt[0] (C semantics) */
  for (size_t i = 0; i < n; i++) {
    int16_t num = d[i];
    size_t jmax = cfg->filt_len - 1 < i ? cfg->filt_len - 1 : i;
    for (size_t j = 1; j <= jmax; j++)
      num = (int16_t)(num - (int16_t)(d[i - j] * (int16_t)cfg->filt[j]));
    d[i] = (int16_t)(num / (int16_t)cfg->filt[0]);
  }
}

/* ------------------------------------------------------------------ */
/* Rice coding                                                        */
/* ------------------------------------------------------------------ */

/* Branchless: the ternary form compiles to a data-dependent branch that
 * mispredicts ~50% on random-sign deltas and costs ~3x encode throughput
 * (measured: 0.4 -> 1.2 GB/s single-thread on Nab-like data). */
static inline uint32_t zigzag16(int16_t v) {
  int32_t x = v;
  return (uint16_t)((x << 1) ^ (x >> 15));
}

static inline int16_t unzigzag16(uint32_t u) {
  return (int16_t)((u >> 1) ^ (uint32_t)-(int32_t)(u & 1));
}

typedef struct {
  uint32_t *dst;
  uint64_t reg;  /* bits accumulate at the top, flushed 32 at a time */
  unsigned nbits;
  size_t pos;
} dr_bitwriter;

static inline void bw_put(dr_bitwriter *w, uint32_t value, unsigned len) {
  w->reg |= (uint64_t)value << (64 - w->nbits - len);
  w->nbits += len;
  if (w->nbits >= 32) {
    w->dst[w->pos++] = (uint32_t)(w->reg >> 32);
    w->reg <<= 32;
    w->nbits -= 32;
  }
}

static void bw_finish(dr_bitwriter *w) {
  if (w->nbits > 0) w->dst[w->pos++] = (uint32_t)(w->reg >> 32);
}

static inline void bw_emit(dr_bitwriter *w, int16_t d, int k) {
  uint32_t u = zigzag16(d);
  uint32_t q = u >> k;
  if (q < DR_ESCAPE_Q) {
    /* q zeros, 1, k-bit remainder — emitted as one (q+1+k)-bit value */
    bw_put(w, (1u << k) | (u & ((1u << k) - 1)), q + 1 + (unsigned)k);
  } else {
    bw_put(w, (1u << 16) | (u & 0xFFFFu), DR_ESCAPE_BITS);
  }
}

/* Filter + Rice-pack one raw segment in a single pass (the pre-filter is
 * applied on the fly, so the int16 data is read exactly once and no
 * intermediate filtered array is ever materialized). */
static size_t pack_segment_raw(const int16_t *x, size_t n,
                               const dr_config *cfg, uint32_t *dst) {
  dr_bitwriter w = {dst, 0, 0, 0};
  if (is_delta(cfg)) {
    int16_t prev = 0;
    for (size_t i = 0; i < n; i++) {
      int16_t cur = x[i];
      bw_emit(&w, (int16_t)(cur - prev), cfg->k);
      prev = cur;
    }
  } else {
    for (size_t i = 0; i < n; i++) {
      int16_t acc = 0;
      size_t jmax = cfg->filt_len - 1 < i ? cfg->filt_len - 1 : i;
      for (size_t j = 0; j <= jmax; j++)
        acc = (int16_t)(acc + (int16_t)(x[i - j] * (int16_t)cfg->filt[j]));
      bw_emit(&w, acc, cfg->k);
    }
  }
  bw_finish(&w);
  return w.pos;
}

typedef struct {
  const uint32_t *src;
  size_t pos;   /* next word */
  uint64_t reg; /* upcoming bits at the top */
  unsigned avail;
  size_t limit;
} dr_bitreader;

static inline void br_fill(dr_bitreader *r) {
  while (r->avail <= 32) {
    uint32_t w = r->pos < r->limit ? r->src[r->pos] : 0;
    r->pos++;
    r->reg |= (uint64_t)w << (32 - r->avail);
    r->avail += 32;
  }
}

static int unpack_segment(const uint32_t *src, size_t n_words, int k,
                          int16_t *out, size_t n) {
  dr_bitreader r = {src, 0, 0, 0, n_words};
  for (size_t i = 0; i < n; i++) {
    br_fill(&r);
    uint32_t top = (uint32_t)(r.reg >> 32);
    /* leading-zero count, capped at the escape cutoff (a valid stream
     * never has more than DR_ESCAPE_Q zeros before a marker bit; the
     * |1 bounds clz for corrupt all-zero windows). Branch-free — the
     * bit-at-a-time scan loop mispredicts on data-dependent q. */
    unsigned q = dr_clz32(top | 1u);
    if (q > DR_ESCAPE_Q) q = DR_ESCAPE_Q;
    uint32_t u;
    unsigned len;
    if (q == DR_ESCAPE_Q) {
      u = (top >> (32 - DR_ESCAPE_BITS)) & 0xFFFFu;
      len = DR_ESCAPE_BITS;
    } else {
      u = (q << k) | ((top >> (32 - q - 1 - k)) & ((1u << k) - 1));
      len = q + 1 + (unsigned)k;
    }
    r.reg <<= len;
    r.avail -= len;
    out[i] = unzigzag16(u);
  }
  return 0;
}

/* ------------------------------------------------------------------ */
/* chunk framing                                                      */
/* ------------------------------------------------------------------ */

static void segment_layout(size_t total, const dr_config *cfg, size_t *nseg,
                           size_t *seg_len) {
  size_t len =
      cfg->seg_len <= 0 ? total : (size_t)cfg->seg_len;
  if (len == 0 || len > total) len = total;
  size_t n = len ? total / len : 0;
  if (n * len < total) n++;
  *nseg = n ? n : (total ? 1 : 0);
  *seg_len = len;
}

int dr_compress(const int16_t *samples, size_t n, const dr_config *cfg,
                uint32_t **out, size_t *out_words) {
  size_t nseg, seg_len;
  segment_layout(n, cfg, &nseg, &seg_len);

  /* Single fused pass: each segment filter+packs straight into its slot
   * of an escape-bound scratch (25 bits/sample worst case), then a
   * parallel compaction memcpy assembles the exact-size framed stream.
   * One read of the input + one copy of the compressed words — about
   * half the memory traffic of a count-then-pack two-phase scheme. */
  size_t max_w = seg_len ? (seg_len * DR_ESCAPE_BITS + 31) / 32 + 1 : 1;
  uint32_t *scratch =
      (uint32_t *)malloc((nseg ? nseg * max_w : 1) * sizeof(uint32_t));
  size_t *words = (size_t *)malloc((nseg + 1) * sizeof(size_t));
  if (!scratch || !words) {
    free(scratch);
    free(words);
    return -1;
  }

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (size_t s = 0; s < nseg; s++) {
    size_t off = s * seg_len;
    size_t len = s + 1 == nseg ? n - off : seg_len;
    words[s + 1] = pack_segment_raw(samples + off, len, cfg,
                                    scratch + s * max_w);
  }
  words[0] = 0;
  for (size_t s = 0; s < nseg; s++) words[s + 1] += words[s];

  size_t total_words = 1 + nseg + words[nseg];
  uint32_t *dst = (uint32_t *)malloc(total_words * sizeof(uint32_t));
  if (!dst) {
    free(scratch);
    free(words);
    return -1;
  }
  dst[0] = (uint32_t)n;

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (size_t s = 0; s < nseg; s++) {
    size_t nw = words[s + 1] - words[s];
    dst[1 + s + words[s]] = (uint32_t)nw;
    memcpy(dst + 2 + s + words[s], scratch + s * max_w,
           nw * sizeof(uint32_t));
  }

  free(scratch);
  free(words);
  *out = dst;
  *out_words = total_words;
  return 0;
}

int dr_decompress(const uint32_t *words, size_t n_words,
                  const dr_config *cfg, int16_t **out, size_t *out_n) {
  if (n_words < 1) return -1;
  size_t total = words[0];
  size_t nseg, seg_len;
  segment_layout(total, cfg, &nseg, &seg_len);

  size_t *starts = (size_t *)malloc((nseg + 1) * sizeof(size_t));
  int16_t *dst = (int16_t *)malloc(total ? total * sizeof(int16_t) : 1);
  if (!starts || !dst) {
    free(starts);
    free(dst);
    return -1;
  }

  /* serial header walk (each header's position depends on the previous) */
  size_t pos = 1;
  for (size_t s = 0; s < nseg; s++) {
    if (pos >= n_words) {
      fprintf(stderr, "deltarice_tpu: truncated stream\n");
      free(starts);
      free(dst);
      return -1;
    }
    starts[s] = pos;
    pos += (size_t)words[pos] + 1;
  }
  if (pos > n_words) {
    fprintf(stderr, "deltarice_tpu: truncated stream\n");
    free(starts);
    free(dst);
    return -1;
  }

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (size_t s = 0; s < nseg; s++) {
    size_t off = s * seg_len;
    size_t len = s + 1 == nseg ? total - off : seg_len;
    size_t nw = words[starts[s]];
    unpack_segment(words + starts[s] + 1, nw, cfg->k, dst + off, len);
    prefilter_invert(dst + off, len, cfg);
  }

  free(starts);
  *out = dst;
  *out_n = total;
  return 0;
}

/* ---- host-side framing helpers for the Python direct-chunk reader ----
 *
 * The header walk is inherently serial (each segment's length header is
 * found only after the previous one, mirroring the reference's start-
 * location scan, src/deltaRice.c:319-325). The Python loop costs ~1 us
 * per segment in the interpreter; a many-thousand-chunk read pays that
 * serially, so the walk and the ragged->padded gather are exported here
 * at C speed. */

int dr_walk_headers(const uint32_t *buf, size_t n_words, size_t nseg,
                    int64_t *counts, int64_t *starts) {
  size_t pos = 1;
  for (size_t s = 0; s < nseg; s++) {
    if (pos >= n_words) return -1;
    size_t c = buf[pos];
    if (c > n_words - pos - 1) return -1;
    counts[s] = (int64_t)c;
    starts[s] = (int64_t)pos;
    pos += c + 1;
  }
  return 0;
}

/* Copy each segment's words into row s of the (nseg, bucket) matrix
 * `out` (caller zero-fills; rows keep >= 1 trailing zero pad word as the
 * decoder's 64-bit window requires — the walk guarantees c + 1 <= bucket
 * is checked by the caller's bucket choice). */
void dr_gather_rows(const uint32_t *buf, size_t nseg, const int64_t *counts,
                    const int64_t *starts, size_t bucket, uint32_t *out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (size_t s = 0; s < nseg; s++) {
    memcpy(out + s * bucket, buf + starts[s] + 1,
           (size_t)counts[s] * sizeof(uint32_t));
  }
}

/* Assemble the framed chunk stream from padded per-segment word rows:
 * out = u32 total | { u32 count_s | words_s }xS — the write-side mirror
 * of dr_gather_rows and the analog of the reference's serial compaction
 * memcpy (/root/reference/src/deltaRice.c:427-432), OpenMP across
 * segments (destinations are disjoint by the exclusive offset scan).
 * `offsets[s]` is the output WORD offset of segment s's header
 * (exclusive prefix of counts+1, +1 for the total header; caller
 * computes it — numpy cumsum is cheap, the 2x-data fancy-index scatter
 * it replaces is not). */
void dr_frame_rows(const uint32_t *words, size_t nseg, size_t stride,
                   const int64_t *counts, const int64_t *offsets,
                   uint32_t total, uint32_t *out) {
  out[0] = total;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (size_t s = 0; s < nseg; s++) {
    uint32_t *dst = out + offsets[s];
    dst[0] = (uint32_t)counts[s];
    memcpy(dst + 1, words + s * stride,
           (size_t)counts[s] * sizeof(uint32_t));
  }
}

/* Concatenate per-sub-block packed word streams at bit offsets.
 *
 * Row r of `words` holds `parts` sub-streams of `w_in` uint32 each
 * (zero-filled past each stream's words, including the final partial
 * word's low bits — the packer's zero-fill makes the shifted OR
 * collision-free); nbits[r*parts + p] is sub-stream p's exact bit
 * length. Output row r (w_out words, caller-zeroed, >= total words + 1)
 * receives the bit-concatenation: byte-identical to encoding the whole
 * waveform serially. No reference counterpart — its parallelism stops
 * at whole waveforms (/root/reference/src/deltaRice.c:417-426). */
void dr_merge_substreams(const uint32_t *words, size_t rows, size_t parts,
                         size_t w_in, const int64_t *nbits, size_t w_out,
                         uint32_t *out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (size_t r = 0; r < rows; r++) {
    uint32_t *dst = out + r * w_out;
    int64_t bit = 0;
    for (size_t p = 0; p < parts; p++) {
      int64_t nb = nbits[r * parts + p];
      if (nb <= 0) continue;
      const uint32_t *src = words + (r * parts + p) * w_in;
      size_t m = (size_t)((nb + 31) >> 5);
      size_t w0 = (size_t)(bit >> 5);
      unsigned sh = (unsigned)(bit & 31);
      if (sh == 0) {
        for (size_t j = 0; j < m; j++) dst[w0 + j] |= src[j];
      } else {
        for (size_t j = 0; j < m; j++) {
          uint32_t w = src[j];
          dst[w0 + j] |= w >> sh;
          dst[w0 + j + 1] |= w << (32u - sh);
        }
      }
      bit += nb;
    }
  }
}
