/* The run decoders of an RLE8/RLE4 BMP (utils/bmp.py), on the host: the
 * stream at data[pos:n] into (h, w) palette indices in file order (the
 * bottom row first for a bottom-up file), out zeroed by the caller.
 *
 * uwt_bmp_rle_cv2 is OpenCV's BmpDecoder::readData: encoded runs, absolute
 * runs padded to a 16-bit word, end of line, delta and end of bitmap, the
 * pixels these skip set to palette entry 0; a run that would cross the
 * row's end gives UWT_BMP_CROSS and data that ends before the bitmap does
 * UWT_BMP_CUT (cv2's None). An RLE8 end of line right after a run that
 * ended the row is skipped; in RLE4 the end of bitmap acts as an end of
 * line and a delta moves right only, as cv2 fills them.
 *
 * uwt_bmp_rle_pil is PIL's BmpRleDecoder: indices appended in file order,
 * runs cut at the row's end, a delta read from the two bytes after its
 * own, stopping at the end of the bitmap, the data or the image; fewer
 * pixels than the image holds give UWT_BMP_SHORT ("not enough image
 * data").
 *
 * Built by ops/kernels/build.py with the host compiler (cc -O2 -shared
 * -fPIC) and called through ctypes by utils/bmp.py.
 */
#include <stdint.h>
#include <string.h>

#define UWT_BMP_CUT -1
#define UWT_BMP_CROSS -2
#define UWT_BMP_SHORT -3

/* cv2's FillUniColor with palette entry 0: `count` pixels from (x, y),
 * wrapping rows, stopping at the image's end */
static void fill_cv2(uint8_t *out, int64_t w, int64_t h, int64_t *x,
                     int64_t *y, int64_t count) {
  for (;;) {
    int64_t end = *x + count < w ? *x + count : w;
    count -= end - *x;
    memset(out + *y * w + *x, 0, (size_t)(end - *x));
    *x = end;
    if (*x >= w) {
      *x = 0;
      if (++*y >= h) return;
    }
    if (count <= 0) return;
  }
}

int32_t uwt_bmp_rle_cv2(const uint8_t *data, int64_t n, int64_t pos,
                        int32_t width, int32_t height, int32_t rle4,
                        uint8_t *out) {
  int64_t w = width, h = height, x = 0, y = 0;
  int flag = 0; /* RLE8's line_end_flag: the last run wrapped the row */
  for (;;) {
    int64_t length, code;
    if (pos + 2 > n) return UWT_BMP_CUT;
    length = data[pos];
    code = data[pos + 1];
    pos += 2;
    if (length) { /* encoded run */
      uint8_t *dst = out + y * w + x;
      if (x + length > w) return UWT_BMP_CROSS;
      if (rle4) {
        for (int64_t i = 0; i < length; i++)
          dst[i] = (uint8_t)(i & 1 ? code & 15 : code >> 4);
        x += length;
      } else {
        int64_t prev = y;
        memset(dst, (int)code, (size_t)length);
        x += length;
        if (x >= w) {
          x = 0;
          y++;
        }
        flag = (int)(y - prev);
        if (y >= h) return 0;
      }
    } else if (code > 2) { /* absolute run */
      int64_t size = rle4 ? (((code + 1) / 2 + 1) & ~1) : ((code + 1) & ~1);
      uint8_t *dst = out + y * w + x;
      if (x + code > w) return UWT_BMP_CROSS;
      if (pos + size > n) return UWT_BMP_CUT;
      if (rle4) {
        for (int64_t i = 0; i < code; i++) {
          uint8_t b = data[pos + i / 2];
          dst[i] = (uint8_t)(i & 1 ? b & 15 : b >> 4);
        }
      } else {
        memcpy(dst, data + pos, (size_t)code);
      }
      pos += size;
      x += code;
      flag = 0;
    } else { /* 0 end of line, 1 end of bitmap, 2 delta */
      int64_t shift = w - x, yshift = h - y;
      if (rle4 || code || !flag || shift < w) {
        if (code == 2) {
          if (pos + 2 > n) return UWT_BMP_CUT;
          shift = data[pos];
          yshift = data[pos + 1];
          pos += 2;
        }
        if (code != 0 && !rle4) shift += yshift * w; /* RLE4: x's only */
        if (y >= h) return 0;
        fill_cv2(out, w, h, &x, &y, shift);
        if (y >= h) return 0;
      }
      flag = 0;
      if (y >= h) return 0;
    }
  }
}

/* appends `count` copies of v (or, with pair, the nibbles of v in turn)
 * at *len, keeping what falls inside the image */
static void put(uint8_t *out, int64_t total, int64_t *len, int64_t count,
                uint8_t v, int pair) {
  for (int64_t i = 0; i < count; i++, ++*len)
    if (*len < total) out[*len] = pair ? (uint8_t)(i & 1 ? v & 15 : v >> 4)
                                       : v;
}

int32_t uwt_bmp_rle_pil(const uint8_t *data, int64_t n, int64_t pos,
                        int32_t width, int32_t height, int32_t rle4,
                        uint8_t *out) {
  int64_t w = width, total = (int64_t)width * height, len = 0, x = 0;
  while (len < total) {
    int64_t count, byte;
    if (pos + 2 > n) break;
    count = data[pos];
    byte = data[pos + 1];
    pos += 2;
    if (count) {
      int64_t room = w - x > 0 ? w - x : 0;
      if (count > room) count = room;
      put(out, total, &len, count, (uint8_t)byte, rle4);
      x += count;
    } else if (byte == 0) {
      put(out, total, &len, (w - len % w) % w, 0, 0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      int64_t right, up;
      if (pos + 2 > n) break;
      pos += 2; /* PIL reads the offsets from the two bytes after them */
      if (pos + 2 > n) {
        right = pos < n ? data[pos] : 0;
        up = pos + 1 < n ? data[pos + 1] : 0;
        put(out, total, &len, right + up * w, 0, 0);
        break;
      }
      right = data[pos];
      up = data[pos + 1];
      pos += 2;
      put(out, total, &len, right + up * w, 0, 0);
      x = len % w;
    } else {
      int64_t want = rle4 ? byte / 2 : byte;
      int64_t take = n - pos < want ? n - pos : want;
      for (int64_t i = 0; i < take; i++)
        put(out, total, &len, rle4 ? 2 : 1, data[pos + i], rle4);
      pos += take;
      if (take < want) break;
      x += byte;
      if (pos % 2) pos++;
    }
  }
  return len < total ? UWT_BMP_SHORT : 0;
}
