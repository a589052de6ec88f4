/* A Zstandard frame decoder (RFC 8878) on the host, for the compressed
 * values of the JAX package's orbax checkpoints (training/ocdbt.py reads
 * them: the OCDBT store's nodes and its zarr chunks are zstd frames).
 *
 * Every block type (raw, RLE, compressed); literals raw, RLE, Huffman-coded
 * in one or four streams and treeless (the previous block's Huffman table);
 * sequences with the predefined, RLE, FSE-compressed and repeat table modes
 * and the three repeat offsets; skippable frames; several frames one after
 * another (their outputs concatenated); the frame content size where a
 * frame gives it (checked) and the XXH64 content checksum where it has one
 * (checked). Dictionaries are refused. The whole output stays in the
 * caller's buffer, so a match may reach back to the frame's first byte
 * whatever the window size.
 *
 * Every read is bounds-checked against its input and every write against
 * the output buffer; a malformed, truncated or corrupt frame returns a
 * negative code (ZSTD_E*), never reads past its buffer and never loops
 * without consuming input or producing output.
 *
 * uwt_crc32c is the CRC-32C (Castagnoli) that closes every file of an OCDBT
 * store.
 *
 * Built by ops/kernels/build.py with the host compiler (cc -O2 -shared
 * -fPIC) and called through ctypes by ops/kernels/zstd.py.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ZSTD_ETRUNC -1    /* input ends inside a frame */
#define ZSTD_EMAGIC -2    /* not a zstd or skippable frame */
#define ZSTD_ECORRUPT -3  /* inconsistent content */
#define ZSTD_EDST -4      /* output buffer too small */
#define ZSTD_ECHECKSUM -5 /* content checksum mismatch */
#define ZSTD_EDICT -6     /* frame needs a dictionary */
#define ZSTD_ESIZE -7     /* output differs from the frame content size */
#define ZSTD_ENOMEM -8

#define BLOCK_MAX 131072
#define MAGIC 0xFD2FB528u

static uint32_t le32(const uint8_t *p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

static uint64_t le64(const uint8_t *p) {
  return (uint64_t)le32(p) | (uint64_t)le32(p + 4) << 32;
}

static int hsb(uint64_t v) { /* index of the highest set bit, -1 for 0 */
  int r = -1;
  while (v) {
    v >>= 1;
    r++;
  }
  return r;
}

/* -- bit readers ----------------------------------------------------------
 * Forward (FSE table descriptions): bits taken from the low end of each
 * little-endian byte up. Backward (Huffman and FSE streams): the stream's
 * last byte holds a 1 above its padding; bits are taken from there down to
 * bit 0 of the first byte, and bits below the first byte read as zeros
 * (the position goes negative, which the callers check). */

typedef struct {
  const uint8_t *p;
  size_t n;
  size_t bit;
  int bad;
} fwd_t;

static uint32_t fwd_read(fwd_t *r, int nb) {
  uint32_t v = 0;
  int i;
  if (r->bit + (size_t)nb > r->n * 8) {
    r->bad = 1;
    return 0;
  }
  for (i = 0; i < nb; i++, r->bit++)
    v |= (uint32_t)((r->p[r->bit >> 3] >> (r->bit & 7)) & 1) << i;
  return v;
}

typedef struct {
  const uint8_t *p;
  size_t n;
  int64_t off; /* bits left above bit 0 of p[0] */
} bwd_t;

static int bwd_init(bwd_t *r, const uint8_t *p, size_t n) {
  if (n == 0 || p[n - 1] == 0) return ZSTD_ECORRUPT;
  r->p = p;
  r->n = n;
  r->off = (int64_t)(n - 1) * 8 + hsb(p[n - 1]);
  return 0;
}

static inline uint64_t bits_at(const bwd_t *r, int64_t off, int nb) {
  size_t byte = (size_t)(off >> 3), i;
  uint64_t v = 0;
  if (byte + 8 <= r->n) {
    v = le64(r->p + byte);
  } else {
    for (i = 0; i < 8 && byte + i < r->n; i++)
      v |= (uint64_t)r->p[byte + i] << (8 * i);
  }
  v >>= (off & 7);
  return v & ((1ull << nb) - 1);
}

static inline uint64_t bwd_read(bwd_t *r, int nb) { /* nb <= 56 */
  int64_t off;
  if (nb == 0) return 0;
  r->off -= nb;
  off = r->off;
  if (off >= 0) return bits_at(r, off, nb);
  if (nb + off <= 0) return 0;
  return bits_at(r, 0, (int)(nb + off)) << (-off);
}

/* -- FSE ------------------------------------------------------------------ */

#define FSE_MAX_LOG 9

typedef struct {
  uint8_t sym[1 << FSE_MAX_LOG];
  uint8_t nb[1 << FSE_MAX_LOG];
  uint16_t base[1 << FSE_MAX_LOG];
  int log;
} fse_t;

static int fse_build(fse_t *t, const int16_t *norm, int nsym, int log) {
  uint16_t next[256];
  int size = 1 << log, high = size - 1, s, i;
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  t->log = log;
  for (s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t->sym[high--] = (uint8_t)s;
      next[s] = 1;
    }
  }
  for (s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = (uint16_t)norm[s];
    for (i = 0; i < norm[s]; i++) {
      t->sym[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return ZSTD_ECORRUPT;
  for (i = 0; i < size; i++) {
    int st = next[t->sym[i]]++;
    int nb = log - hsb((uint64_t)st);
    t->nb[i] = (uint8_t)nb;
    t->base[i] = (uint16_t)((st << nb) - size);
  }
  return 0;
}

static void fse_rle(fse_t *t, uint8_t sym) {
  t->log = 0;
  t->sym[0] = sym;
  t->nb[0] = 0;
  t->base[0] = 0;
}

/* An FSE table description (RFC 8878 4.1.1); *used gets its byte size. */
static int fse_read(fse_t *t, const uint8_t *p, size_t n, int max_log,
                    int max_sym, size_t *used) {
  int16_t norm[256];
  fwd_t r = {p, n, 0, 0};
  int log, remaining, sym = 0;
  log = (int)fwd_read(&r, 4) + 5;
  if (r.bad) return ZSTD_ETRUNC;
  if (log > max_log) return ZSTD_ECORRUPT;
  remaining = 1 << log;
  while (remaining > 0 && sym <= max_sym) {
    int nbits = hsb((uint64_t)remaining + 1) + 1;
    uint32_t val = fwd_read(&r, nbits);
    uint32_t lower = (1u << (nbits - 1)) - 1;
    uint32_t thr = (1u << nbits) - 1 - (uint32_t)(remaining + 1);
    int prob;
    if (r.bad) return ZSTD_ETRUNC;
    if ((val & lower) < thr) {
      r.bit--;
      val &= lower;
    } else if (val > lower) {
      val -= thr;
    }
    prob = (int)val - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[sym++] = (int16_t)prob;
    if (prob == 0) {
      for (;;) {
        int rep = (int)fwd_read(&r, 2), i;
        if (r.bad) return ZSTD_ETRUNC;
        for (i = 0; i < rep; i++) {
          if (sym > max_sym) return ZSTD_ECORRUPT;
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0 || sym > max_sym + 1) return ZSTD_ECORRUPT;
  *used = (r.bit + 7) >> 3;
  return fse_build(t, norm, sym, log);
}

static inline int fse_update(const fse_t *t, int st, bwd_t *r) {
  return t->base[st] + (int)bwd_read(r, t->nb[st]);
}

/* -- Huffman literals ----------------------------------------------------- */

#define HUF_MAX_BITS 11

typedef struct {
  uint8_t sym[1 << HUF_MAX_BITS];
  uint8_t nb[1 << HUF_MAX_BITS];
  int max_bits;
} huf_t;

static int huf_from_weights(huf_t *t, const uint8_t *w, int nw) {
  uint8_t bits[256];
  uint32_t rank_idx[HUF_MAX_BITS + 2], rank_count[HUF_MAX_BITS + 2];
  uint64_t sum = 0, left;
  int max_bits, last, i, nsym = nw + 1;
  if (nsym > 256) return ZSTD_ECORRUPT;
  for (i = 0; i < nw; i++) {
    if (w[i] > HUF_MAX_BITS) return ZSTD_ECORRUPT;
    if (w[i]) sum += 1ull << (w[i] - 1);
  }
  if (sum == 0) return ZSTD_ECORRUPT;
  max_bits = hsb(sum) + 1;
  if (max_bits > HUF_MAX_BITS) return ZSTD_ECORRUPT;
  left = (1ull << max_bits) - sum;
  if (left & (left - 1)) return ZSTD_ECORRUPT; /* not a power of two */
  last = hsb(left) + 1;                        /* the implied weight */
  for (i = 0; i < nw; i++) bits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
  bits[nw] = (uint8_t)(max_bits + 1 - last);
  memset(rank_count, 0, sizeof rank_count);
  for (i = 0; i < nsym; i++) rank_count[bits[i]]++;
  rank_idx[max_bits] = 0;
  for (i = max_bits; i >= 1; i--) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
    if (rank_idx[i - 1] > (1u << max_bits)) return ZSTD_ECORRUPT;
    memset(t->nb + rank_idx[i], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != (1u << max_bits)) return ZSTD_ECORRUPT;
  for (i = 0; i < nsym; i++) {
    if (bits[i]) {
      uint32_t code = rank_idx[bits[i]], len = 1u << (max_bits - bits[i]);
      memset(t->sym + code, i, len);
      rank_idx[bits[i]] += len;
    }
  }
  t->max_bits = max_bits;
  return 0;
}

/* The Huffman tree description; returns its byte size or a code. */
static int64_t huf_read(huf_t *t, const uint8_t *p, size_t n) {
  uint8_t w[256];
  int nw = 0, rc;
  size_t size;
  if (n < 1) return ZSTD_ETRUNC;
  if (p[0] >= 128) { /* weights stored directly, 4 bits each */
    int i;
    nw = p[0] - 127;
    size = (size_t)(nw + 1) / 2;
    if (1 + size > n) return ZSTD_ETRUNC;
    for (i = 0; i < nw; i++)
      w[i] = (uint8_t)(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
  } else { /* FSE-compressed weights, two interleaved states */
    fse_t ft;
    bwd_t r;
    size_t used;
    int s1, s2;
    size = p[0];
    if (1 + size > n) return ZSTD_ETRUNC;
    if ((rc = fse_read(&ft, p + 1, size, 6, 255, &used)) < 0) return rc;
    if (used >= size) return ZSTD_ECORRUPT;
    if ((rc = bwd_init(&r, p + 1 + used, size - used)) < 0) return rc;
    s1 = (int)bwd_read(&r, ft.log);
    s2 = (int)bwd_read(&r, ft.log);
    for (;;) {
      if (nw >= 255) return ZSTD_ECORRUPT;
      w[nw++] = ft.sym[s1];
      s1 = fse_update(&ft, s1, &r);
      if (r.off < 0) {
        if (nw >= 255) return ZSTD_ECORRUPT;
        w[nw++] = ft.sym[s2];
        break;
      }
      if (nw >= 255) return ZSTD_ECORRUPT;
      w[nw++] = ft.sym[s2];
      s2 = fse_update(&ft, s2, &r);
      if (r.off < 0) {
        if (nw >= 255) return ZSTD_ECORRUPT;
        w[nw++] = ft.sym[s1];
        break;
      }
    }
  }
  if ((rc = huf_from_weights(t, w, nw)) < 0) return rc;
  return (int64_t)(1 + size);
}

static int huf_stream(const huf_t *t, const uint8_t *p, size_t n,
                      uint8_t *out, size_t count) {
  bwd_t r;
  int rc, mb = t->max_bits, mask = (1 << mb) - 1, st;
  size_t i;
  if ((rc = bwd_init(&r, p, n)) < 0) return rc;
  st = (int)bwd_read(&r, mb);
  for (i = 0; i < count; i++) {
    int nb = t->nb[st];
    out[i] = t->sym[st];
    st = ((st << nb) + (int)bwd_read(&r, nb)) & mask;
    if (r.off < -(int64_t)mb) return ZSTD_ECORRUPT;
  }
  return r.off == -(int64_t)mb ? 0 : ZSTD_ECORRUPT;
}

/* -- sequences ------------------------------------------------------------ */

static const uint32_t LL_BASE[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                                    0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                                    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,   16,   17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27,  28,  29,  30,   31,   32,
    33, 34, 35, 37, 39, 41, 43, 47, 51, 59,  67,  83,  99,   131,  259,
    515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* the predefined distributions (RFC 8878 3.1.1.3.2.2) */
static const int16_t LL_DEFAULT[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

typedef struct {
  fse_t ll, of, ml;
  int have_ll, have_of, have_ml, have_huf;
  huf_t huf;
  uint32_t rep[3];
  uint8_t lit[BLOCK_MAX + 8];
} ctx_t;

/* One of the three tables of a sequences section, by its mode. */
static int64_t seq_table(fse_t *t, int *have, int mode, const uint8_t *p,
                         size_t n, int max_log, int max_sym,
                         const int16_t *def, int def_n, int def_log) {
  size_t used = 0;
  int rc;
  switch (mode) {
    case 0:
      if ((rc = fse_build(t, def, def_n, def_log)) < 0) return rc;
      break;
    case 1:
      if (n < 1) return ZSTD_ETRUNC;
      if (p[0] > max_sym) return ZSTD_ECORRUPT;
      fse_rle(t, p[0]);
      used = 1;
      break;
    case 2:
      if ((rc = fse_read(t, p, n, max_log, max_sym, &used)) < 0) return rc;
      break;
    default:
      if (!*have) return ZSTD_ECORRUPT;
      break;
  }
  *have = 1;
  return (int64_t)used;
}

/* A compressed block into dst[*pos...]; fstart is the frame's first output
 * byte. */
static int compressed_block(ctx_t *c, const uint8_t *p, size_t n,
                            uint8_t *dst, size_t cap, size_t fstart,
                            size_t *pos) {
  int type, sf, rc;
  size_t hs, regen, lsize, nseq, i, o = *pos, lit_left;
  const uint8_t *lit;
  if (n < 1) return ZSTD_ETRUNC;
  type = p[0] & 3;
  sf = (p[0] >> 2) & 3;
  if (type < 2) { /* raw or RLE literals */
    if (sf == 1) {
      hs = 2;
    } else if (sf == 3) {
      hs = 3;
    } else {
      hs = 1;
    }
    if (n < hs) return ZSTD_ETRUNC;
    regen = hs == 1 ? (size_t)(p[0] >> 3)
          : hs == 2 ? (size_t)(p[0] >> 4) + ((size_t)p[1] << 4)
                    : (size_t)(p[0] >> 4) + ((size_t)p[1] << 4) +
                          ((size_t)p[2] << 12);
    if (regen > BLOCK_MAX) return ZSTD_ECORRUPT;
    if (type == 0) {
      if (n < hs + regen) return ZSTD_ETRUNC;
      lit = p + hs;
      lsize = hs + regen;
    } else {
      if (n < hs + 1) return ZSTD_ETRUNC;
      memset(c->lit, p[hs], regen);
      lit = c->lit;
      lsize = hs + 1;
    }
  } else { /* Huffman-coded literals, with their tree or the last one */
    size_t comp, streams = sf == 0 ? 1 : 4;
    int64_t tree = 0;
    uint64_t v;
    hs = sf < 2 ? 3 : sf == 2 ? 4 : 5;
    if (n < hs) return ZSTD_ETRUNC;
    for (v = 0, i = 0; i < hs; i++) v |= (uint64_t)p[i] << (8 * i);
    if (hs == 3) {
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
    } else if (hs == 4) {
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
    } else {
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
    }
    if (regen > BLOCK_MAX) return ZSTD_ECORRUPT;
    if (n < hs + comp) return ZSTD_ETRUNC;
    if (type == 2) {
      tree = huf_read(&c->huf, p + hs, comp);
      if (tree < 0) return (int)tree;
      c->have_huf = 1;
    } else if (!c->have_huf) {
      return ZSTD_ECORRUPT;
    }
    {
      const uint8_t *s = p + hs + tree;
      size_t left = comp - (size_t)tree;
      if (streams == 1) {
        if ((rc = huf_stream(&c->huf, s, left, c->lit, regen)) < 0) return rc;
      } else {
        size_t sz[4], per = (regen + 3) / 4, k, at = 6, outpos = 0;
        if (left < 6) return ZSTD_ECORRUPT;
        sz[0] = s[0] | (size_t)s[1] << 8;
        sz[1] = s[2] | (size_t)s[3] << 8;
        sz[2] = s[4] | (size_t)s[5] << 8;
        if (sz[0] + sz[1] + sz[2] + 6 > left) return ZSTD_ECORRUPT;
        sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
        if (per * 3 > regen) return ZSTD_ECORRUPT;
        for (k = 0; k < 4; k++) {
          size_t cnt = k < 3 ? per : regen - 3 * per;
          if ((rc = huf_stream(&c->huf, s + at, sz[k], c->lit + outpos, cnt)) <
              0)
            return rc;
          at += sz[k];
          outpos += cnt;
        }
      }
    }
    lit = c->lit;
    lsize = hs + comp;
  }
  p += lsize;
  n -= lsize;
  lit_left = regen;

  /* sequences */
  if (n < 1) return ZSTD_ETRUNC;
  if (p[0] == 0) {
    nseq = 0;
    p++;
    n--;
    if (n != 0) return ZSTD_ECORRUPT;
  } else if (p[0] < 128) {
    nseq = p[0];
    p++;
    n--;
  } else if (p[0] < 255) {
    if (n < 2) return ZSTD_ETRUNC;
    nseq = ((size_t)(p[0] - 128) << 8) + p[1];
    p += 2;
    n -= 2;
  } else {
    if (n < 3) return ZSTD_ETRUNC;
    nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
    p += 3;
    n -= 3;
  }
  if (nseq) {
    int modes, ll_st, of_st, ml_st;
    int64_t used;
    bwd_t r;
    if (n < 1) return ZSTD_ETRUNC;
    modes = p[0];
    p++;
    n--;
    if (modes & 3) return ZSTD_ECORRUPT;
    used = seq_table(&c->ll, &c->have_ll, modes >> 6, p, n, 9, 35, LL_DEFAULT,
                     36, 6);
    if (used < 0) return (int)used;
    p += used;
    n -= (size_t)used;
    used = seq_table(&c->of, &c->have_of, (modes >> 4) & 3, p, n, 8, 31,
                     OF_DEFAULT, 29, 5);
    if (used < 0) return (int)used;
    p += used;
    n -= (size_t)used;
    used = seq_table(&c->ml, &c->have_ml, (modes >> 2) & 3, p, n, 9, 52,
                     ML_DEFAULT, 53, 6);
    if (used < 0) return (int)used;
    p += used;
    n -= (size_t)used;
    if ((rc = bwd_init(&r, p, n)) < 0) return rc;
    ll_st = (int)bwd_read(&r, c->ll.log);
    of_st = (int)bwd_read(&r, c->of.log);
    ml_st = (int)bwd_read(&r, c->ml.log);
    for (i = 0; i < nseq; i++) {
      int llc = c->ll.sym[ll_st], ofc = c->of.sym[of_st],
          mlc = c->ml.sym[ml_st];
      uint64_t offv;
      size_t ll, ml, off, k;
      if (llc > 35 || mlc > 52 || ofc > 31) return ZSTD_ECORRUPT;
      offv = (1ull << ofc) + bwd_read(&r, ofc);
      ml = ML_BASE[mlc] + (size_t)bwd_read(&r, ML_BITS[mlc]);
      ll = LL_BASE[llc] + (size_t)bwd_read(&r, LL_BITS[llc]);
      if (i + 1 < nseq) {
        ll_st = fse_update(&c->ll, ll_st, &r);
        ml_st = fse_update(&c->ml, ml_st, &r);
        of_st = fse_update(&c->of, of_st, &r);
      }
      if (r.off < 0) return ZSTD_ECORRUPT;
      if (offv > 3) {
        off = (size_t)(offv - 3);
        c->rep[2] = c->rep[1];
        c->rep[1] = c->rep[0];
        c->rep[0] = (uint32_t)off;
      } else {
        int idx = (int)offv - 1 + (ll == 0);
        if (idx == 0) {
          off = c->rep[0];
        } else {
          off = idx == 3 ? c->rep[0] - 1 : c->rep[idx];
          if (idx != 1) c->rep[2] = c->rep[1];
          c->rep[1] = c->rep[0];
          c->rep[0] = (uint32_t)off;
        }
      }
      if (ll > lit_left) return ZSTD_ECORRUPT;
      if (ll + ml > cap - o) return ZSTD_EDST;
      memcpy(dst + o, lit, ll);
      o += ll;
      lit += ll;
      lit_left -= ll;
      if (off == 0 || off > o - fstart) return ZSTD_ECORRUPT;
      if (off >= ml) {
        memcpy(dst + o, dst + o - off, ml);
      } else {
        for (k = 0; k < ml; k++) dst[o + k] = dst[o + k - off];
      }
      o += ml;
    }
    if (r.off != 0) return ZSTD_ECORRUPT;
  }
  if (lit_left > cap - o) return ZSTD_EDST;
  memcpy(dst + o, lit, lit_left);
  o += lit_left;
  if (o - *pos > BLOCK_MAX) return ZSTD_ECORRUPT;
  *pos = o;
  return 0;
}

/* -- XXH64 ---------------------------------------------------------------- */

#define P1 11400714785074694791ull
#define P2 14029467366897019727ull
#define P3 1609587929392839161ull
#define P4 9650029242287828579ull
#define P5 2870177450012600261ull

static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}

static uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

static uint64_t xxh64(const uint8_t *p, int64_t len_, uint64_t seed) {
  size_t len = (size_t)len_, i = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; i + 32 <= len; i += 32) {
      v1 = xround(v1, le64(p + i));
      v2 = xround(v2, le64(p + i + 8));
      v3 = xround(v3, le64(p + i + 16));
      v4 = xround(v4, le64(p + i + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  for (; i + 8 <= len; i += 8) {
    h ^= xround(0, le64(p + i));
    h = rotl(h, 27) * P1 + P4;
  }
  if (i + 4 <= len) {
    h ^= (uint64_t)le32(p + i) * P1;
    h = rotl(h, 23) * P2 + P3;
    i += 4;
  }
  for (; i < len; i++) {
    h ^= p[i] * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

/* -- frames --------------------------------------------------------------- */

typedef struct {
  size_t hsize;     /* header bytes */
  int64_t content;  /* frame content size, -1 when absent */
  int checksum;
} fhdr_t;

static int frame_header(const uint8_t *p, size_t n, fhdr_t *h) {
  int fd, fcs_flag, single, did_flag, did_size, fcs_size;
  size_t at = 5;
  uint64_t fcs = 0;
  int k;
  if (n < 5) return ZSTD_ETRUNC;
  fd = p[4];
  fcs_flag = fd >> 6;
  single = (fd >> 5) & 1;
  did_flag = fd & 3;
  if (fd & 8) return ZSTD_ECORRUPT; /* reserved bit */
  h->checksum = (fd >> 2) & 1;
  if (!single) at++; /* window descriptor */
  did_size = did_flag == 3 ? 4 : did_flag;
  fcs_size = fcs_flag == 0 ? single : 1 << fcs_flag;
  if (n < at + (size_t)did_size + (size_t)fcs_size) return ZSTD_ETRUNC;
  for (k = 0; k < did_size; k++)
    if (p[at + k]) return ZSTD_EDICT;
  at += (size_t)did_size;
  for (k = 0; k < fcs_size; k++) fcs |= (uint64_t)p[at + k] << (8 * k);
  if (fcs_size == 2) fcs += 256;
  at += (size_t)fcs_size;
  h->hsize = at;
  h->content = fcs_size ? (int64_t)fcs : -1;
  return 0;
}

static int64_t decode_frame(ctx_t *c, const uint8_t *src, size_t n,
                            uint8_t *dst, size_t cap, size_t *pos) {
  fhdr_t h;
  size_t at, fstart = *pos;
  int rc, last = 0;
  if ((rc = frame_header(src, n, &h)) < 0) return rc;
  at = h.hsize;
  c->have_ll = c->have_of = c->have_ml = c->have_huf = 0;
  c->rep[0] = 1;
  c->rep[1] = 4;
  c->rep[2] = 8;
  while (!last) {
    uint32_t bh;
    size_t size;
    int type;
    if (n - at < 3) return ZSTD_ETRUNC;
    bh = (uint32_t)src[at] | (uint32_t)src[at + 1] << 8 |
         (uint32_t)src[at + 2] << 16;
    at += 3;
    last = bh & 1;
    type = (bh >> 1) & 3;
    size = bh >> 3;
    if (size > BLOCK_MAX) return ZSTD_ECORRUPT;
    if (type == 1) { /* RLE: one byte, repeated size times */
      if (n - at < 1) return ZSTD_ETRUNC;
      if (size > cap - *pos) return ZSTD_EDST;
      memset(dst + *pos, src[at], size);
      *pos += size;
      at += 1;
      continue;
    }
    if (n - at < size) return ZSTD_ETRUNC;
    if (type == 0) {
      if (size > cap - *pos) return ZSTD_EDST;
      memcpy(dst + *pos, src + at, size);
      *pos += size;
    } else if (type == 2) {
      if ((rc = compressed_block(c, src + at, size, dst, cap, fstart, pos)) <
          0)
        return rc;
    } else {
      return ZSTD_ECORRUPT;
    }
    at += size;
  }
  if (h.content >= 0 && (uint64_t)h.content != *pos - fstart)
    return ZSTD_ESIZE;
  if (h.checksum) {
    if (n - at < 4) return ZSTD_ETRUNC;
    if ((uint32_t)xxh64(dst + fstart, (int64_t)(*pos - fstart), 0) !=
        le32(src + at))
      return ZSTD_ECHECKSUM;
    at += 4;
  }
  return (int64_t)at;
}

/* Every frame of src[0:n] into dst[0:cap]: the bytes written, or a negative
 * ZSTD_E* code. */
int64_t uwt_zstd_decompress(const uint8_t *src, int64_t n_, uint8_t *dst,
                            int64_t cap_) {
  size_t n = (size_t)n_, cap = (size_t)cap_, at = 0, pos = 0;
  ctx_t *c;
  if (n_ < 0 || cap_ < 0) return ZSTD_ECORRUPT;
  if (n == 0) return ZSTD_ETRUNC;
  c = (ctx_t *)malloc(sizeof(ctx_t));
  if (!c) return ZSTD_ENOMEM;
  while (at < n) {
    uint32_t magic;
    if (n - at < 4) {
      free(c);
      return ZSTD_ETRUNC;
    }
    magic = le32(src + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) { /* skippable frame */
      uint32_t size;
      if (n - at < 8) {
        free(c);
        return ZSTD_ETRUNC;
      }
      size = le32(src + at + 4);
      if (n - at - 8 < size) {
        free(c);
        return ZSTD_ETRUNC;
      }
      at += 8 + (size_t)size;
      continue;
    }
    if (magic != MAGIC) {
      free(c);
      return ZSTD_EMAGIC;
    }
    {
      int64_t used = decode_frame(c, src + at, n - at, dst, cap, &pos);
      if (used < 0) {
        free(c);
        return used;
      }
      at += (size_t)used;
    }
  }
  free(c);
  return (int64_t)pos;
}

/* The sum of the content sizes the frames of src[0:n] declare; -2 where a
 * frame declares none, another negative code for a malformed input. Walks
 * the block headers without decoding. */
int64_t uwt_zstd_content_size(const uint8_t *src, int64_t n_) {
  size_t n = (size_t)n_, at = 0;
  int64_t total = 0;
  int unknown = 0;
  if (n_ <= 0) return ZSTD_ETRUNC;
  while (at < n) {
    uint32_t magic;
    fhdr_t h;
    int rc, last = 0;
    if (n - at < 4) return ZSTD_ETRUNC;
    magic = le32(src + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - at < 8) return ZSTD_ETRUNC;
      if (n - at - 8 < le32(src + at + 4)) return ZSTD_ETRUNC;
      at += 8 + (size_t)le32(src + at + 4);
      continue;
    }
    if (magic != MAGIC) return ZSTD_EMAGIC;
    if ((rc = frame_header(src + at, n - at, &h)) < 0) return rc;
    at += h.hsize;
    while (!last) {
      uint32_t bh;
      size_t size;
      if (n - at < 3) return ZSTD_ETRUNC;
      bh = (uint32_t)src[at] | (uint32_t)src[at + 1] << 8 |
           (uint32_t)src[at + 2] << 16;
      last = bh & 1;
      size = ((bh >> 1) & 3) == 1 ? 1 : bh >> 3;
      if (n - at - 3 < size) return ZSTD_ETRUNC;
      at += 3 + size;
    }
    if (h.checksum) at += 4;
    if (at > n) return ZSTD_ETRUNC;
    if (h.content < 0) unknown = 1;
    else total += h.content;
  }
  return unknown ? -2 : total;
}

/* CRC-32C (reflected polynomial 0x82F63B78), bytewise from a table. */
uint32_t uwt_crc32c(const uint8_t *p, int64_t n) {
  static uint32_t table[256];
  static int ready = 0;
  uint32_t crc = 0xFFFFFFFFu;
  int64_t i;
  if (!ready) {
    uint32_t k, j, c;
    for (k = 0; k < 256; k++) {
      for (c = k, j = 0; j < 8; j++) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      table[k] = c;
    }
    ready = 1;
  }
  for (i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}
