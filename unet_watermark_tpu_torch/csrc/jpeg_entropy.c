/* The JPEG entropy decode on the host: one scan's Huffman-coded data into
 * per-component int16 coefficient arrays, (blocks_h, blocks_w, 64) in
 * natural order. The same rules as utils/jpeg.py's plain decoder (which the
 * tests hold it equal to): libjpeg's bit reader (0xFF 0x00 stuffing, 0xFF
 * fill bytes, zeros past a marker, the out-of-data flag set once a bit past
 * the real data is taken and the MCUs after it left as they are), baseline
 * blocks, the four progressive scan kinds with EOB runs, and restart
 * intervals with jpeg_resync_to_restart's rules.
 *
 * uwt_jpeg_encode_scan is the other direction, as libjpeg's jchuff.c
 * writes a baseline scan without restarts: the blocks of an interleaved
 * scan in coding order, each DC as the difference from the previous block
 * of its component, the AC coefficients as run/size symbols with ZRL and
 * EOB, 0xFF bytes stuffed with 0x00 and the last byte padded with 1-bits.
 *
 * Built by ops/kernels/build.py with the host compiler (cc -O2 -shared
 * -fPIC) and called through ctypes by ops/kernels/jpeg_entropy.py. Huffman
 * tables come as 65536-entry lookups from utils/jpeg.huffman_lookup: entry
 * (code length << 8) | symbol for each 16-bit window, 0 where no code of
 * 16 bits or fewer starts it.
 */
#include <stdint.h>
#include <string.h>

typedef struct {
  int16_t *coef;   /* (bh, bw, 64) */
  int32_t bw;      /* block columns allocated */
  int32_t h, v;    /* sampling factors (blocks of an interleaved MCU) */
} uwt_jpeg_comp;

/* zigzag -> natural order, with the 16 entries past 63 libjpeg reads on
 * corrupt data */
static const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define END_MARKER 0x100

typedef struct {
  const uint8_t *data;
  int64_t pos, end;
  uint64_t acc;
  int nb;      /* bits buffered */
  int pad;     /* of which zeros past a marker */
  int marker;  /* pending marker code, END_MARKER at the end, -1 none */
  int short_;  /* a bit past the real data was taken */
} bits_t;

static void fill(bits_t *b) {
  while (b->nb < 25) {
    if (b->marker < 0) {
      int c;
      if (b->pos >= b->end) {
        b->marker = END_MARKER;
        continue;
      }
      c = b->data[b->pos++];
      if (c == 0xFF) {
        while (b->pos < b->end && b->data[b->pos] == 0xFF) b->pos++;
        if (b->pos >= b->end) {
          b->marker = END_MARKER;
          continue;
        }
        c = b->data[b->pos++];
        if (c != 0) {
          b->marker = c;
          continue;
        }
        c = 0xFF;
      }
      b->acc = (b->acc << 8) | (uint64_t)c;
    } else {
      b->acc <<= 8;
      b->pad += 8;
    }
    b->nb += 8;
  }
}

static inline int take(bits_t *b, int k) {
  if (b->nb < k) fill(b);
  b->nb -= k;
  if (b->nb < b->pad) {
    b->short_ = 1;
    b->pad = b->nb;
  }
  return (int)((b->acc >> b->nb) & ((1u << k) - 1u));
}

static inline int huff(bits_t *b, const int32_t *lut) {
  int32_t e;
  if (b->nb < 16) fill(b);
  e = lut[(b->acc >> (b->nb - 16)) & 0xFFFF];
  if (!e) { /* no code of 16 bits or fewer: libjpeg gives 0 after 17 */
    take(b, 16);
    take(b, 1);
    return 0;
  }
  take(b, e >> 8);
  return e & 0xFF;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static void skip_to_marker(bits_t *b) {
  for (;;) {
    int c;
    while (b->pos < b->end && b->data[b->pos] != 0xFF) b->pos++;
    while (b->pos < b->end && b->data[b->pos] == 0xFF) b->pos++;
    if (b->pos >= b->end) {
      b->marker = END_MARKER;
      return;
    }
    c = b->data[b->pos++];
    if (c != 0) {
      b->marker = c;
      return;
    }
  }
}

/* At a restart boundary: drop the buffered bits, find the next marker and
 * resync as jpeg_resync_to_restart does. 1 where the marker was swallowed
 * (the out-of-data flag is then cleared). */
static int restart(bits_t *b, int expected) {
  b->acc = 0;
  b->nb = b->pad = 0;
  for (;;) {
    int m, action;
    if (b->marker < 0) skip_to_marker(b);
    m = b->marker;
    if (m == 0xD0 + expected)
      action = 1;
    else if (m == END_MARKER || (m >= 0xC0 && !(m >= 0xD0 && m <= 0xD7)))
      action = 3;
    else if (m < 0xC0)
      action = 2;
    else if (m == 0xD0 + ((expected + 1) & 7) ||
             m == 0xD0 + ((expected + 2) & 7))
      action = 3;
    else if (m == 0xD0 + ((expected - 1) & 7) ||
             m == 0xD0 + ((expected - 2) & 7))
      action = 2;
    else
      action = 1;
    if (action == 1) {
      b->marker = -1;
      return 1;
    }
    if (action == 3) return 0;
    b->marker = -1;
  }
}

/* Decode one scan. comps[i] and the luts belong to the scan's i-th
 * component; an MCU of a one-component scan is one block of that
 * component's block grid, mcus_across blocks wide. Returns the index of the
 * MCU at which the data ran out (-1 where it did not), or -2 for bad
 * arguments. */
int uwt_jpeg_decode_scan(const uint8_t *data, int64_t start, int64_t end,
                         const uwt_jpeg_comp *comps, int32_t ncomps,
                         const int32_t *const *dc_luts,
                         const int32_t *const *ac_luts, int32_t n_mcu,
                         int32_t mcus_across, int32_t ss, int32_t se,
                         int32_t ah, int32_t al, int32_t progressive,
                         int32_t restart_interval) {
  bits_t b;
  int32_t last_dc[4] = {0, 0, 0, 0};
  int32_t eobrun = 0, restarts_to_go = restart_interval, next_rst = 0;
  int short_ = 0;
  int32_t cut = -1;
  int dc_refine = progressive && ss == 0 && ah != 0;
  int need_dc = !progressive || (ss == 0 && ah == 0);
  int ac_first = progressive && ss != 0 && ah == 0;
  int p1 = 1 << al, m1 = -(1 << al);
  int32_t mcu;
  if (ncomps < 1 || ncomps > 4 || mcus_across < 1 || se > 63 || ss > se)
    return -2;
  memset(&b, 0, sizeof b);
  b.data = data;
  b.pos = start;
  b.end = end;
  b.marker = -1;
  for (mcu = 0; mcu < n_mcu; mcu++) {
    int32_t my = mcu / mcus_across, mx = mcu % mcus_across;
    int i;
    if (restart_interval) {
      if (restarts_to_go == 0) {
        if (restart(&b, next_rst)) short_ = 0, cut = -1;
        b.short_ = 0;
        next_rst = (next_rst + 1) & 7;
        memset(last_dc, 0, sizeof last_dc);
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      restarts_to_go--;
    }
    if (short_) continue; /* out of data: the MCU keeps what it has */
    for (i = 0; i < ncomps; i++) {
      const uwt_jpeg_comp *c = &comps[i];
      int nby = ncomps == 1 ? 1 : c->v, nbx = ncomps == 1 ? 1 : c->h;
      int by, bx;
      for (by = 0; by < nby; by++) {
        for (bx = 0; bx < nbx; bx++) {
          int64_t row = ncomps == 1 ? my : (int64_t)my * c->v + by;
          int64_t col = ncomps == 1 ? mx : (int64_t)mx * c->h + bx;
          int16_t *blk = c->coef + (row * c->bw + col) * 64;
          int k, r, s;
          if (dc_refine) {
            if (take(&b, 1)) blk[0] = (int16_t)(blk[0] | p1);
            continue;
          }
          if (need_dc) {
            int32_t diff = 0;
            s = huff(&b, dc_luts[i]);
            if (s) diff = extend(take(&b, s), s);
            last_dc[i] = (int32_t)((uint32_t)last_dc[i] + (uint32_t)diff);
            if (!progressive) {
              const int32_t *lut = ac_luts[i];
              memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = (int16_t)last_dc[i];
              for (k = 1; k < 64; k++) {
                int rs = huff(&b, lut);
                r = rs >> 4;
                s = rs & 15;
                if (s) {
                  k += r;
                  blk[kNatural[k]] = (int16_t)extend(take(&b, s), s);
                } else if (r != 15) {
                  break;
                } else {
                  k += 15;
                }
              }
            } else {
              blk[0] = (int16_t)((uint32_t)last_dc[i] << al);
            }
            continue;
          }
          if (ac_first) {
            const int32_t *lut = ac_luts[i];
            if (eobrun) {
              eobrun--;
              continue;
            }
            for (k = ss; k <= se; k++) {
              int rs = huff(&b, lut);
              r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] =
                    (int16_t)((uint32_t)extend(take(&b, s), s) << al);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = (1 << r) + (r ? take(&b, r) : 0) - 1;
                break;
              }
            }
            continue;
          }
          /* AC refinement (jdphuff.c decode_mcu_AC_refine) */
          {
            const int32_t *lut = ac_luts[i];
            k = ss;
            if (eobrun == 0) {
              for (; k <= se; k++) {
                int rs = huff(&b, lut);
                r = rs >> 4;
                s = rs & 15;
                if (s) {
                  s = take(&b, 1) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = (1 << r) + (r ? take(&b, r) : 0);
                  break;
                }
                while (k <= se) {
                  int16_t *coef = blk + kNatural[k];
                  if (*coef) {
                    if (take(&b, 1) && !(*coef & p1))
                      *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                  } else if (--r < 0) {
                    break;
                  }
                  k++;
                }
                if (s) blk[kNatural[k]] = (int16_t)s;
              }
            }
            if (eobrun > 0) {
              for (; k <= se; k++) {
                int16_t *coef = blk + kNatural[k];
                if (*coef && take(&b, 1) && !(*coef & p1))
                  *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
              }
              eobrun--;
            }
          }
        }
      }
    }
    if (b.short_ && !short_) short_ = 1, cut = mcu;
  }
  return cut;
}

/* ------------------------------------------------------------------------
 * Baseline Huffman encoding.
 * blocks: (n, 64) int16 quantized coefficients in zigzag order, in coding
 * order; comp[i]: the block's table set and DC predictor (0..ncomp-1);
 * codes/lens: for each table set, 256 DC codes then 256 AC codes (code
 * value, length in bits; length 0 where the symbol has no code).
 * Writes at most cap bytes to out; returns the count, or -1 if cap is too
 * small, -2 for a symbol without a code. */

typedef struct {
  uint8_t *out;
  int64_t n, cap;
  uint64_t acc;  /* bits not yet written, right-aligned */
  int nb;
  int overflow;
} wbits_t;

static inline void put_bits(wbits_t *w, uint32_t code, int len) {
  w->acc = (w->acc << len) | (code & ((1u << len) - 1u));
  w->nb += len;
  while (w->nb >= 8) {
    uint8_t byte = (uint8_t)(w->acc >> (w->nb - 8));
    w->nb -= 8;
    if (w->n + 2 > w->cap) {
      w->overflow = 1;
      return;
    }
    w->out[w->n++] = byte;
    if (byte == 0xFF) w->out[w->n++] = 0x00;
  }
}

static inline int nbits(int v) {
  int a = v < 0 ? -v : v, s = 0;
  while (a) {
    s++;
    a >>= 1;
  }
  return s;
}

int64_t uwt_jpeg_encode_scan(const int16_t *blocks, int64_t n,
                             const int32_t *comp, int32_t ncomp,
                             const uint32_t *codes, const int32_t *lens,
                             uint8_t *out, int64_t cap) {
  wbits_t w = {out, 0, cap, 0, 0, 0};
  int last_dc[4] = {0, 0, 0, 0};
  if (ncomp < 1 || ncomp > 4) return -3;
  for (int64_t i = 0; i < n; i++) {
    const int16_t *b = blocks + i * 64;
    int c = comp[i];
    const uint32_t *dcc = codes + c * 512, *acc = dcc + 256;
    const int32_t *dcl = lens + c * 512, *acl = dcl + 256;
    int diff = b[0] - last_dc[c];
    last_dc[c] = b[0];
    int s = nbits(diff);
    if (!dcl[s]) return -2;
    put_bits(&w, dcc[s], dcl[s]);
    if (s) put_bits(&w, (uint32_t)(diff < 0 ? diff - 1 : diff), s);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      int v = b[k];
      if (!v) {
        run++;
        continue;
      }
      while (run > 15) {
        if (!acl[0xF0]) return -2;
        put_bits(&w, acc[0xF0], acl[0xF0]);
        run -= 16;
      }
      s = nbits(v);
      int sym = (run << 4) | s;
      if (!acl[sym]) return -2;
      put_bits(&w, acc[sym], acl[sym]);
      put_bits(&w, (uint32_t)(v < 0 ? v - 1 : v), s);
      run = 0;
    }
    if (run) {
      if (!acl[0]) return -2;
      put_bits(&w, acc[0], acl[0]);
    }
    if (w.overflow) return -1;
  }
  if (w.nb) put_bits(&w, 0x7F, 8 - w.nb); /* pad with 1-bits */
  return w.overflow ? -1 : w.n;
}
