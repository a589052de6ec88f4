/* TIFF's LZW and PackBits codecs on the host, as libtiff 4.x codes them,
 * for utils/tiff.py (the reader) and utils/synthetic.py (the writer).
 *
 * LZW: codes of 9 to 12 bits, most significant bit first; 256 clears the
 * table, 257 ends the strip; the first free code is 258 and the code
 * width grows one code early (the decoder reads 10 bits once its table
 * holds 511 entries, as libtiff's "new-style" LZW does). A strip that ends
 * without the end code stops there; a code past the table's end is an
 * error. The encoder clears its table once it holds 4094 entries, as
 * libtiff's does.
 *
 * PackBits: a header byte n in 0..127 copies n + 1 bytes, -127..-1
 * repeats the next byte 1 - n times, -128 is skipped; output past the
 * buffer is dropped and input that ends early stops the decoder, as
 * libtiff's PackBitsDecode does.
 *
 * The decoders return the bytes written (the caller checks that the strip
 * is whole), or a negative code; every read and write is bounds-checked.
 * Built by ops/kernels/build.py with the host compiler and called through
 * ctypes by ops/kernels/tiff.py.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define TIFF_ECORRUPT -2
#define TIFF_EDST -4
#define TIFF_ENOMEM -5

#define CLEAR 256
#define EOI 257
#define FIRST 258
#define TABLE 4096

int64_t uwt_lzw_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                       int64_t cap) {
  uint16_t prefix[TABLE];
  uint8_t suffix[TABLE], first[TABLE];
  uint16_t length[TABLE];
  uint8_t stack[TABLE];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int64_t out = 0, bitpos = 0, nbits_total = n * 8;
  int nbits = 9, free_ent = FIRST, old = -1;
  for (;;) {
    if (bitpos + nbits > nbits_total) break; /* no end code: stop */
    uint32_t code = 0;
    for (int i = 0; i < nbits; ++i, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == EOI) break;
    if (code == CLEAR) {
      nbits = 9;
      free_ent = FIRST;
      old = -1;
      continue;
    }
    int c = (int)code;
    if (old < 0) {
      if (c > 255) return TIFF_ECORRUPT;
      if (out < cap) dst[out] = (uint8_t)c;
      out++;
      old = c;
      continue;
    }
    /* libtiff counts entries past 12 bits' reach (no code can name them)
       up to its table's size, 5119 */
    if (c > free_ent || free_ent >= TABLE + 1023) return TIFF_ECORRUPT;
    if (free_ent < TABLE) {
      /* the new entry: the previous string and this one's first byte */
      prefix[free_ent] = (uint16_t)old;
      first[free_ent] = first[old];
      length[free_ent] = (uint16_t)(length[old] + 1);
      suffix[free_ent] = c < free_ent ? first[c] : first[old];
    }
    free_ent++;
    if (free_ent > (1 << nbits) - 2 && nbits < 12) nbits++;
    int len = length[c], k = len, e = c;
    while (k > 0) {
      stack[--k] = suffix[e];
      e = prefix[e];
    }
    for (int i = 0; i < len; ++i, ++out)
      if (out < cap) dst[out] = stack[i];
    old = c;
  }
  return out < cap ? out : cap;
}

static void put_code(uint8_t *dst, int64_t *bitpos, uint32_t code,
                     int nbits) {
  for (int i = nbits - 1; i >= 0; --i, ++*bitpos)
    if ((code >> i) & 1) dst[*bitpos >> 3] |= (uint8_t)(0x80 >> (*bitpos & 7));
}

/* `cap` must allow 12 bits a byte plus a few codes: 3 * n / 2 + 16 */
int64_t uwt_lzw_encode(const uint8_t *src, int64_t n, uint8_t *dst,
                       int64_t cap) {
  if (cap < 3 * n / 2 + 16) return TIFF_EDST;
  int32_t *next = malloc(sizeof(int32_t) * TABLE * 256);
  if (!next) return TIFF_ENOMEM;
  memset(dst, 0, (size_t)cap);
  int64_t bitpos = 0;
  int nbits = 9, free_ent = FIRST;
  memset(next, 0xff, sizeof(int32_t) * TABLE * 256);
  put_code(dst, &bitpos, CLEAR, nbits);
  int w = -1;
  for (int64_t i = 0; i < n; ++i) {
    int c = src[i];
    if (w < 0) {
      w = c;
      continue;
    }
    int32_t k = next[w * 256 + c];
    if (k >= 0) {
      w = k;
      continue;
    }
    put_code(dst, &bitpos, (uint32_t)w, nbits);
    next[w * 256 + c] = free_ent++;
    w = c;
    if (free_ent == TABLE - 2) {
      put_code(dst, &bitpos, CLEAR, nbits);
      memset(next, 0xff, sizeof(int32_t) * TABLE * 256);
      free_ent = FIRST;
      nbits = 9;
    } else if (free_ent > (1 << nbits) - 1) {
      nbits++;
    }
  }
  if (w >= 0) {
    put_code(dst, &bitpos, (uint32_t)w, nbits);
    if (++free_ent == TABLE - 2) {
      put_code(dst, &bitpos, CLEAR, nbits);
      nbits = 9;
    } else if (free_ent > (1 << nbits) - 1) {
      nbits++;
    }
  }
  put_code(dst, &bitpos, EOI, nbits);
  free(next);
  return (bitpos + 7) >> 3;
}

int64_t uwt_packbits_decode(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap) {
  int64_t in = 0, out = 0;
  while (in < n && out < cap) {
    int h = (int8_t)src[in++];
    if (h < 0) {
      if (h == -128) continue;
      int64_t run = 1 - h;
      if (run > cap - out) run = cap - out;
      if (in >= n) break;
      memset(dst + out, src[in++], (size_t)run);
      out += run;
    } else {
      int64_t len = h + 1;
      if (len > cap - out) len = cap - out;
      if (n - in < len) break;
      memcpy(dst + out, src + in, (size_t)len);
      out += len;
      in += len;
    }
  }
  return out;
}

/* PackBits of each `row` bytes on their own, runs of 3 or more repeated */
int64_t uwt_packbits_encode(const uint8_t *src, int64_t n, int64_t row,
                            uint8_t *dst, int64_t cap) {
  int64_t out = 0;
  for (int64_t start = 0; start < n; start += row) {
    int64_t end = start + row < n ? start + row : n, i = start;
    while (i < end) {
      int64_t run = 1;
      while (i + run < end && run < 128 && src[i + run] == src[i]) run++;
      if (run >= 3) {
        if (out + 2 > cap) return TIFF_EDST;
        dst[out++] = (uint8_t)(1 - run);
        dst[out++] = src[i];
        i += run;
        continue;
      }
      int64_t lit = 0;
      while (i + lit < end && lit < 128) {
        if (i + lit + 2 < end && src[i + lit] == src[i + lit + 1] &&
            src[i + lit] == src[i + lit + 2])
          break;
        lit++;
      }
      if (out + 1 + lit > cap) return TIFF_EDST;
      dst[out++] = (uint8_t)(lit - 1);
      memcpy(dst + out, src + i, (size_t)lit);
      out += lit;
      i += lit;
    }
  }
  return out;
}
