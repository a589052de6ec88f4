/* WEBP decoding on the host: the VP8 key frame (lossy), the VP8L image
 * (lossless) and the ALPH chunk, as libwebp 1.x decodes them (the decoder
 * cv2 5.0 and Pillow 12 are built with), for utils/webp.py.
 *
 * VP8 (RFC 6386): the boolean decoder with libwebp's end-of-data rule (a
 * partition is cut once a bit past its last byte is needed); segments,
 * their map and probabilities, absolute or delta quantizers and filter
 * levels; 1, 2, 4 or 8 token partitions; the coefficient probabilities and
 * their updates; the skip flag; dequantisation per segment with the five
 * plane deltas (y2 AC at 155/100, at least 8); the inverse WHT and DCT
 * with libwebp's MUL1/MUL2 constants; every 16x16, 4x4 (B_PRED, the
 * above-right pixels at the macroblock's right edge taken from the row
 * above, replicated down) and chroma intra mode with the 127/129 borders;
 * the simple and the normal loop filter over the whole frame after
 * reconstruction (intra prediction reads unfiltered pixels), with
 * sharpness, the mode and reference deltas and inner edges skipped for
 * macroblocks without coefficients that are not B_PRED. The result is the
 * Y, U and V planes (4:2:0), cropped to the picture; the caller converts
 * them to RGB (ops/webp.py).
 *
 * VP8L: prefix codes, simple and normal, with the code-length code;
 * meta prefix codes (the entropy image); the colour cache; backward
 * references with the 120-entry distance map; the predictor (14 modes),
 * cross-colour, subtract-green and colour-indexing (with pixel bundling)
 * transforms, undone in reverse order. The result is ARGB, one uint32 a
 * pixel. A stream that needs bits past its end fails, with libwebp's
 * allowance (a stream shorter than 8 bytes reads zeros up to 64 bits).
 *
 * ALPH: compression 0 (raw) and 1 (a VP8L stream without its header; the
 * alpha is its green channel), filters none, horizontal, vertical and
 * gradient.
 *
 * Every read is bounds-checked; a malformed or truncated stream returns a
 * negative code (WEBP_E*). Built by ops/kernels/build.py with the host
 * compiler and called through ctypes by ops/kernels/webp.py.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define WEBP_ETRUNC -1       /* the data end before the image does */
#define WEBP_ECORRUPT -2     /* an invalid header, code or reference */
#define WEBP_EUNSUPPORTED -3 /* not a shown key frame */
#define WEBP_ENOMEM -4
#define WEBP_ESIZE -5        /* the size disagrees with the container's */

/* the default coefficient probabilities [type][band][context][node]
   (RFC 6386 13.5) */
static const uint8_t COEFFS0[4 * 8 * 3 * 11] = {
  128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,
  253,136,254,255,228,219,128,128,128,128,128,189,129,242,255,227,213,255,219,128,128,128,106,126,227,252,214,209,255,255,128,128,128,
  1,98,248,255,236,226,255,255,128,128,128,181,133,238,254,221,234,255,154,128,128,128,78,134,202,247,198,180,255,219,128,128,128,
  1,185,249,255,243,255,128,128,128,128,128,184,150,247,255,236,224,128,128,128,128,128,77,110,216,255,236,230,128,128,128,128,128,
  1,101,251,255,241,255,128,128,128,128,128,170,139,241,252,236,209,255,255,128,128,128,37,116,196,243,228,255,255,255,128,128,128,
  1,204,254,255,245,255,128,128,128,128,128,207,160,250,255,238,128,128,128,128,128,128,102,103,231,255,211,171,128,128,128,128,128,
  1,152,252,255,240,255,128,128,128,128,128,177,135,243,255,234,225,128,128,128,128,128,80,129,211,255,194,224,128,128,128,128,128,
  1,1,255,128,128,128,128,128,128,128,128,246,1,255,128,128,128,128,128,128,128,128,255,128,128,128,128,128,128,128,128,128,128,
  198,35,237,223,193,187,162,160,145,155,62,131,45,198,221,172,176,220,157,252,221,1,68,47,146,208,149,167,221,162,255,223,128,
  1,149,241,255,221,224,255,255,128,128,128,184,141,234,253,222,220,255,199,128,128,128,81,99,181,242,176,190,249,202,255,255,128,
  1,129,232,253,214,197,242,196,255,255,128,99,121,210,250,201,198,255,202,128,128,128,23,91,163,242,170,187,247,210,255,255,128,
  1,200,246,255,234,255,128,128,128,128,128,109,178,241,255,231,245,255,255,128,128,128,44,130,201,253,205,192,255,255,128,128,128,
  1,132,239,251,219,209,255,165,128,128,128,94,136,225,251,218,190,255,255,128,128,128,22,100,174,245,186,161,255,199,128,128,128,
  1,182,249,255,232,235,128,128,128,128,128,124,143,241,255,227,234,128,128,128,128,128,35,77,181,251,193,211,255,205,128,128,128,
  1,157,247,255,236,231,255,255,128,128,128,121,141,235,255,225,227,255,255,128,128,128,45,99,188,251,195,217,255,224,128,128,128,
  1,1,251,255,213,255,128,128,128,128,128,203,1,248,255,255,128,128,128,128,128,128,137,1,177,255,224,255,128,128,128,128,128,
  253,9,248,251,207,208,255,192,128,128,128,175,13,224,243,193,185,249,198,255,255,128,73,17,171,221,161,179,236,167,255,234,128,
  1,95,247,253,212,183,255,255,128,128,128,239,90,244,250,211,209,255,255,128,128,128,155,77,195,248,188,195,255,255,128,128,128,
  1,24,239,251,218,219,255,205,128,128,128,201,51,219,255,196,186,128,128,128,128,128,69,46,190,239,201,218,255,228,128,128,128,
  1,191,251,255,255,128,128,128,128,128,128,223,165,249,255,213,255,128,128,128,128,128,141,124,248,255,255,128,128,128,128,128,128,
  1,16,248,255,255,128,128,128,128,128,128,190,36,230,255,236,255,128,128,128,128,128,149,1,255,128,128,128,128,128,128,128,128,
  1,226,255,128,128,128,128,128,128,128,128,247,192,255,128,128,128,128,128,128,128,128,240,128,255,128,128,128,128,128,128,128,128,
  1,134,252,255,255,128,128,128,128,128,128,213,62,250,255,255,128,128,128,128,128,128,55,93,255,128,128,128,128,128,128,128,128,
  128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,128,
  202,24,213,235,186,191,220,160,240,175,255,126,38,182,232,169,184,228,174,255,187,128,61,46,138,219,151,178,240,170,255,216,128,
  1,112,230,250,199,191,247,159,255,255,128,166,109,228,252,211,215,255,174,128,128,128,39,77,162,232,172,180,245,178,255,255,128,
  1,52,220,246,198,199,249,220,255,255,128,124,74,191,243,183,193,250,221,255,255,128,24,71,130,219,154,170,243,182,255,255,128,
  1,182,225,249,219,240,255,224,128,128,128,149,150,226,252,216,205,255,171,128,128,128,28,108,170,242,183,194,254,223,255,255,128,
  1,81,230,252,204,203,255,192,128,128,128,123,102,209,247,188,196,255,233,128,128,128,20,95,153,243,164,173,255,203,128,128,128,
  1,222,248,255,216,213,128,128,128,128,128,168,175,246,252,235,205,255,255,128,128,128,47,116,215,255,211,212,255,255,128,128,128,
  1,121,236,253,212,214,255,255,128,128,128,141,84,213,252,201,202,255,219,128,128,128,42,80,160,240,162,185,255,205,128,128,128,
  1,1,255,128,128,128,128,128,128,128,128,244,1,255,128,128,128,128,128,128,128,128,238,1,255,128,128,128,128,128,128,128,128,
};
/* the probabilities that each of those is updated (RFC 6386 13.4) */
static const uint8_t COEFFS_UPDATE[4 * 8 * 3 * 11] = {
  255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  176,246,255,255,255,255,255,255,255,255,255,223,241,252,255,255,255,255,255,255,255,255,249,253,253,255,255,255,255,255,255,255,255,
  255,244,252,255,255,255,255,255,255,255,255,234,254,254,255,255,255,255,255,255,255,255,253,255,255,255,255,255,255,255,255,255,255,
  255,246,254,255,255,255,255,255,255,255,255,239,253,254,255,255,255,255,255,255,255,255,254,255,254,255,255,255,255,255,255,255,255,
  255,248,254,255,255,255,255,255,255,255,255,251,255,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,253,254,255,255,255,255,255,255,255,255,251,254,254,255,255,255,255,255,255,255,255,254,255,254,255,255,255,255,255,255,255,255,
  255,254,253,255,254,255,255,255,255,255,255,250,255,254,255,254,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  217,255,255,255,255,255,255,255,255,255,255,225,252,241,253,255,255,254,255,255,255,255,234,250,241,250,253,255,253,254,255,255,255,
  255,254,255,255,255,255,255,255,255,255,255,223,254,254,255,255,255,255,255,255,255,255,238,253,254,254,255,255,255,255,255,255,255,
  255,248,254,255,255,255,255,255,255,255,255,249,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,253,255,255,255,255,255,255,255,255,255,247,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,253,254,255,255,255,255,255,255,255,255,252,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,254,254,255,255,255,255,255,255,255,255,253,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,254,253,255,255,255,255,255,255,255,255,250,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  186,251,250,255,255,255,255,255,255,255,255,234,251,244,254,255,255,255,255,255,255,255,251,251,243,253,254,255,254,255,255,255,255,
  255,253,254,255,255,255,255,255,255,255,255,236,253,254,255,255,255,255,255,255,255,255,251,253,253,254,254,255,255,255,255,255,255,
  255,254,254,255,255,255,255,255,255,255,255,254,254,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,254,255,255,255,255,255,255,255,255,255,254,254,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  248,255,255,255,255,255,255,255,255,255,255,250,254,252,254,255,255,255,255,255,255,255,248,254,249,253,255,255,255,255,255,255,255,
  255,253,253,255,255,255,255,255,255,255,255,246,253,253,255,255,255,255,255,255,255,255,252,254,251,254,254,255,255,255,255,255,255,
  255,254,252,255,255,255,255,255,255,255,255,248,254,253,255,255,255,255,255,255,255,255,253,255,254,254,255,255,255,255,255,255,255,
  255,251,254,255,255,255,255,255,255,255,255,245,251,254,255,255,255,255,255,255,255,255,253,253,254,255,255,255,255,255,255,255,255,
  255,251,253,255,255,255,255,255,255,255,255,252,253,254,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,
  255,252,255,255,255,255,255,255,255,255,255,249,255,254,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,
  255,255,253,255,255,255,255,255,255,255,255,250,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
  255,255,255,255,255,255,255,255,255,255,255,254,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,
};
/* a key frame's 4x4 mode probabilities [above][left][node] in this
   file's mode order (RFC 6386 11.5, reordered) */
static const uint8_t BMODES_PROBA[10 * 10 * 9] = {
  231,120,48,89,115,113,120,152,112,152,179,64,126,170,118,46,70,95,175,69,143,80,85,82,72,155,103,
  56,58,10,171,218,189,17,13,152,114,26,17,163,44,195,21,10,173,121,24,80,195,26,62,44,64,85,
  144,71,10,38,171,213,144,34,26,170,46,55,19,136,160,33,206,71,63,20,8,114,114,208,12,9,226,
  81,40,11,96,182,84,29,16,36,134,183,89,137,98,101,106,165,148,72,187,100,130,157,111,32,75,80,
  66,102,167,99,74,62,40,234,128,41,53,9,178,241,141,26,8,107,74,43,26,146,73,166,49,23,157,
  65,38,105,160,51,52,31,115,128,104,79,12,27,217,255,87,17,7,87,68,71,44,114,51,15,186,23,
  47,41,14,110,182,183,21,17,194,66,45,25,102,197,189,23,18,22,88,88,147,150,42,46,45,196,205,
  43,97,183,117,85,38,35,179,61,39,53,200,87,26,21,43,232,171,56,34,51,104,114,102,29,93,77,
  39,28,85,171,58,165,90,98,64,34,22,116,206,23,34,43,166,73,107,54,32,26,51,1,81,43,31,
  68,25,106,22,64,171,36,225,114,34,19,21,102,132,188,16,76,124,62,18,78,95,85,57,50,48,51,
  193,101,35,159,215,111,89,46,111,60,148,31,172,219,228,21,18,111,112,113,77,85,179,255,38,120,114,
  40,42,1,196,245,209,10,25,109,88,43,29,140,166,213,37,43,154,61,63,30,155,67,45,68,1,209,
  100,80,8,43,154,1,51,26,71,142,78,78,16,255,128,34,197,171,41,40,5,102,211,183,4,1,221,
  51,50,17,168,209,192,23,25,82,138,31,36,171,27,166,38,44,229,67,87,58,169,82,115,26,59,179,
  63,59,90,180,59,166,93,73,154,40,40,21,116,143,209,34,39,175,47,15,16,183,34,223,49,45,183,
  46,17,33,183,6,98,15,32,183,57,46,22,24,128,1,54,17,37,65,32,73,115,28,128,23,128,205,
  40,3,9,115,51,192,18,6,223,87,37,9,115,59,77,64,21,47,104,55,44,218,9,54,53,130,226,
  64,90,70,205,40,41,23,26,57,54,57,112,184,5,41,38,166,213,30,34,26,133,152,116,10,32,134,
  39,19,53,221,26,114,32,73,255,31,9,65,234,2,15,1,118,73,75,32,12,51,192,255,160,43,51,
  88,31,35,67,102,85,55,186,85,56,21,23,111,59,205,45,37,192,55,38,70,124,73,102,1,34,98,
  125,98,42,88,104,85,117,175,82,95,84,53,89,128,100,113,101,45,75,79,123,47,51,128,81,171,1,
  57,17,5,71,102,57,53,41,49,38,33,13,121,57,73,26,1,85,41,10,67,138,77,110,90,47,114,
  115,21,2,10,102,255,166,23,6,101,29,16,10,85,128,101,196,26,57,18,10,102,102,213,34,20,43,
  117,20,15,36,163,128,68,1,26,102,61,71,37,34,53,31,243,192,69,60,71,38,73,119,28,222,37,
  68,45,128,34,1,47,11,245,171,62,17,19,70,146,85,55,62,70,37,43,37,154,100,163,85,160,1,
  63,9,92,136,28,64,32,201,85,75,15,9,9,64,255,184,119,16,86,6,28,5,64,255,25,248,1,
  56,8,17,132,137,255,55,116,128,58,15,20,82,135,57,26,121,40,164,50,31,137,154,133,25,35,218,
  51,103,44,131,131,123,31,6,158,86,40,64,135,148,224,45,183,128,22,26,17,131,240,154,14,1,209,
  45,16,21,91,64,222,7,1,197,56,21,39,155,60,138,23,102,213,83,12,13,54,192,255,68,47,28,
  85,26,85,85,128,128,32,146,171,18,11,7,63,144,171,4,4,246,35,27,10,146,174,171,12,26,128,
  190,80,35,99,180,80,126,54,45,85,126,47,87,176,51,41,20,32,101,75,128,139,118,146,116,128,85,
  56,41,15,176,236,85,37,9,62,71,30,17,119,118,255,17,18,138,101,38,60,138,55,70,43,26,142,
  146,36,19,30,171,255,97,27,20,138,45,61,62,219,1,81,188,64,32,41,20,117,151,142,20,21,163,
  112,19,12,61,195,128,48,4,24,
};
/* VP8L's distance codes 1-120: (dy << 4) | (8 - dx) */
static const uint8_t PLANE_CODES[120] = {
  24,7,23,25,40,6,39,41,22,26,38,42,56,5,55,57,21,27,54,58,
  37,43,72,4,71,73,20,28,53,59,70,74,36,44,88,69,75,52,60,3,
  87,89,19,29,86,90,35,45,68,76,85,91,51,61,104,2,103,105,18,30,
  102,106,34,46,84,92,67,77,101,107,50,62,120,1,119,121,83,93,17,31,
  100,108,66,78,118,122,33,47,117,123,49,63,99,109,82,94,0,116,124,65,
  79,16,32,98,110,48,115,125,81,95,64,114,126,97,111,80,113,127,96,112,
};

/* ------------------------------------------------------------------ VP8 */

#define BPS 32  /* the work buffer's stride, as libwebp's */
#define Y_OFF (BPS * 1 + 8)
#define U_OFF (Y_OFF + BPS * 16 + BPS)
#define V_OFF (U_OFF + 16)
#define YUV_SIZE (BPS * 17 + BPS * 9)

/* modes, in libwebp's order: the 16x16 and chroma modes share the first
   four numbers with the 4x4 modes */
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

static const uint8_t DC_TABLE[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154,
  157};
static const uint16_t AC_TABLE[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149,
  152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201,
  205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
  274, 279, 284};
static const uint8_t BANDS[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6,
                                  6, 7, 0};
static const uint8_t ZIGZAG[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7,
                                   11, 14, 15};
static const uint8_t CAT3[] = {173, 148, 140, 0};
static const uint8_t CAT4[] = {176, 155, 140, 135, 0};
static const uint8_t CAT5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t CAT6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133,
                               130, 129, 0};
static const uint8_t *const CAT3456[] = {CAT3, CAT4, CAT5, CAT6};
/* the 4x4 mode tree: a leaf is the negated mode */
static const int8_t YMODES_INTRA4[18] = {
  -B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7,
  -B_VL, 8, -B_HD, -B_HU};
static const int SCAN[16] = {
  0 + 0 * BPS, 4 + 0 * BPS, 8 + 0 * BPS, 12 + 0 * BPS,
  0 + 4 * BPS, 4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
  0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
  0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

/* the boolean decoder; `range` holds the range minus one, `value` the
   bits + 8 bits not yet consumed */
typedef struct {
  const uint8_t *buf, *end;
  uint64_t value;
  int bits;
  uint32_t range;
  int eof;
} BoolReader;

static void br_load(BoolReader *br) {
  if (br->buf < br->end) {
    br->bits += 8;
    br->value = (br->value << 8) | *br->buf++;
  } else if (!br->eof) {
    br->value <<= 8;
    br->bits += 8;
    br->eof = 1;
  } else {
    br->bits = 0;
  }
}

static void br_init(BoolReader *br, const uint8_t *start, size_t size) {
  br->buf = start;
  br->end = start + size;
  br->value = 0;
  br->bits = -8;
  br->range = 255 - 1;
  br->eof = 0;
  br_load(br);
}

static inline int get_bit(BoolReader *br, int prob) {
  uint32_t range = br->range;
  if (br->bits < 0) br_load(br);
  int pos = br->bits;
  uint32_t split = (range * (uint32_t)prob) >> 8;
  uint32_t value = (uint32_t)(br->value >> pos);
  int bit = value > split;
  if (bit) {
    range -= split;
    br->value -= (uint64_t)(split + 1) << pos;
  } else {
    range = split + 1;
  }
  int shift = 7 ^ (31 - __builtin_clz(range));
  range <<= shift;
  br->bits -= shift;
  br->range = range - 1;
  return bit;
}

static inline int get_signed(BoolReader *br, int v) {
  if (br->bits < 0) br_load(br);
  int pos = br->bits;
  uint32_t split = br->range >> 1;
  uint32_t value = (uint32_t)(br->value >> pos);
  int32_t mask = (int32_t)(split - value) >> 31;
  br->bits -= 1;
  br->range += (uint32_t)mask;
  br->range |= 1;
  br->value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
  return (v ^ mask) - mask;
}

static int get_value(BoolReader *br, int nbits) {
  int v = 0;
  while (nbits-- > 0) v |= get_bit(br, 0x80) << nbits;
  return v;
}

static int get_signed_value(BoolReader *br, int nbits) {
  int v = get_value(br, nbits);
  return get_bit(br, 0x80) ? -v : v;
}

typedef struct {
  int y1[2], y2[2], uv[2];
} Quant;

typedef struct {
  uint8_t limit, ilevel, inner, hev;
} FInfo;

typedef struct {
  uint8_t nz, nz_dc;
} NzCtx;

typedef struct {
  int mb_w, mb_h;
  /* segment header */
  int use_segment, update_map, absolute_delta;
  int quantizer[4], filter_strength[4];
  uint8_t seg_proba[3];
  /* filter header */
  int simple, level, sharpness, use_lf_delta;
  int ref_lf_delta[4], mode_lf_delta[4];
  int filter_type;
  Quant dqm[4];
  FInfo fstrengths[4][2];
  uint8_t proba[4][8][3][11];
  int use_skip, skip_p;
  int num_parts;
  BoolReader parts[8];
} VP8;

static int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

static void parse_quant(VP8 *d, BoolReader *br) {
  int base_q0 = get_value(br, 7);
  int dqy1_dc = get_bit(br, 0x80) ? get_signed_value(br, 4) : 0;
  int dqy2_dc = get_bit(br, 0x80) ? get_signed_value(br, 4) : 0;
  int dqy2_ac = get_bit(br, 0x80) ? get_signed_value(br, 4) : 0;
  int dquv_dc = get_bit(br, 0x80) ? get_signed_value(br, 4) : 0;
  int dquv_ac = get_bit(br, 0x80) ? get_signed_value(br, 4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d->use_segment) {
      q = d->quantizer[i];
      if (!d->absolute_delta) q += base_q0;
    } else if (i > 0) {
      d->dqm[i] = d->dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant *m = &d->dqm[i];
    m->y1[0] = DC_TABLE[clip_q(q + dqy1_dc, 127)];
    m->y1[1] = AC_TABLE[clip_q(q, 127)];
    m->y2[0] = DC_TABLE[clip_q(q + dqy2_dc, 127)] * 2;
    m->y2[1] = (AC_TABLE[clip_q(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m->y2[1] < 8) m->y2[1] = 8;
    m->uv[0] = DC_TABLE[clip_q(q + dquv_dc, 117)];
    m->uv[1] = AC_TABLE[clip_q(q + dquv_ac, 127)];
  }
}

static void filter_strengths(VP8 *d) {
  for (int s = 0; s < 4; ++s) {
    int base = d->level;
    if (d->use_segment) {
      base = d->filter_strength[s];
      if (!d->absolute_delta) base += d->level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo *info = &d->fstrengths[s][i4x4];
      int level = base;
      if (d->use_lf_delta) {
        level += d->ref_lf_delta[0];
        if (i4x4) level += d->mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d->sharpness > 0) {
          ilevel >>= d->sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d->sharpness) ilevel = 9 - d->sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info->ilevel = (uint8_t)ilevel;
        info->limit = (uint8_t)(2 * level + ilevel);
        info->hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info->limit = 0;
      }
      info->inner = (uint8_t)i4x4;
    }
  }
}

/* one block's tokens from position n on; returns the position after the
   last nonzero token (16 where the block is full) */
static int get_coeffs(BoolReader *br, uint8_t (*const bands)[3][11], int ctx,
                      const int *dq, int n, int16_t *out) {
  const uint8_t *p = bands[BANDS[n]][ctx];
  for (; n < 16; ++n) {
    if (!get_bit(br, p[0])) return n;
    while (!get_bit(br, p[1])) {
      p = bands[BANDS[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!get_bit(br, p[2])) {
      v = 1;
      p = bands[BANDS[n + 1]][1];
    } else {
      if (!get_bit(br, p[3])) {
        if (!get_bit(br, p[4])) {
          v = 2;
        } else {
          v = 3 + get_bit(br, p[5]);
        }
      } else if (!get_bit(br, p[6])) {
        if (!get_bit(br, p[7])) {
          v = 5 + get_bit(br, 159);
        } else {
          v = 7 + 2 * get_bit(br, 165);
          v += get_bit(br, 145);
        }
      } else {
        int bit1 = get_bit(br, p[8]);
        int bit0 = get_bit(br, p[9 + bit1]);
        int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t *tab = CAT3456[cat]; *tab; ++tab)
          v += v + get_bit(br, *tab);
        v += 3 + (8 << cat);
      }
      p = bands[BANDS[n + 1]][2];
    }
    out[ZIGZAG[n]] = (int16_t)(get_signed(br, v) * dq[n > 0]);
  }
  return 16;
}

static void transform_wht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[0 + i] + in[12 + i];
    int a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i];
    int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0 + i * 4] + 3;
    int a0 = dc + tmp[3 + i * 4];
    int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

static inline uint8_t clip8(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v;
}

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

/* the inverse DCT of one 4x4 block, added to the prediction in dst */
static void transform_one(const int16_t *in, uint8_t *dst) {
  int c[16], *tmp = c;
  for (int i = 0; i < 4; ++i) {
    int a = in[0] + in[8];
    int b = in[0] - in[8];
    int cc = MUL2(in[4]) - MUL1(in[12]);
    int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[0] + 4;
    int a = dc + tmp[8];
    int b = dc - tmp[8];
    int cc = MUL2(tmp[4]) - MUL1(tmp[12]);
    int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void fill_block(uint8_t *dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

static void true_motion(uint8_t *dst, int size) {
  const uint8_t *top = dst - BPS;
  int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    int l = dst[-1 + y * BPS] - tl;
    for (int x = 0; x < size; ++x) dst[x + y * BPS] = clip8(top[x] + l);
  }
}

/* a 16x16 (size 16) or chroma (size 8) prediction */
static void predict_block(uint8_t *dst, int mode, int size) {
  int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case B_DC:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill_block(dst, (dc + size) >> (shift + 1), size);
      break;
    case DC_NOTOP:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, (dc + (size >> 1)) >> shift, size);
      break;
    case DC_NOLEFT:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill_block(dst, (dc + (size >> 1)) >> shift, size);
      break;
    case DC_NOTOPLEFT:
      fill_block(dst, 0x80, size);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j)
        memset(dst + j * BPS, dst[-1 + j * BPS], size);
      break;
  }
}

static void predict4(uint8_t *dst, int mode) {
  const uint8_t *top = dst - BPS;
  int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3];
  int E = top[4], F = top[5], G = top[6], H = top[7];
  int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                      AVG3(C, D, E)};
      for (int j = 0; j < 4; ++j) memcpy(dst + j * BPS, v, 4);
      break;
    }
    case B_HE:
      memset(dst + 0 * BPS, AVG3(X, I, J), 4);
      memset(dst + 1 * BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    case B_HU:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          (uint8_t)L;
      break;
  }
}

static int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

/* the loop filter (libwebp's dsp/dec.c, on planes of any stride) */
static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static inline void do_filter2(uint8_t *p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

static inline void do_filter4(uint8_t *p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

static inline void do_filter6(uint8_t *p, int step) {
  int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7;
  int a2 = (18 * a + 63) >> 7;
  int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

static inline int hev(const uint8_t *p, int step, int thresh) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static inline int needs_filter(const uint8_t *p, int step, int t) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static inline int needs_filter2(const uint8_t *p, int step, int t, int it) {
  int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  int p0 = p[-step], q0 = p[0];
  int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return 0;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

/* `size` pixels along an edge: hstride across it, vstride along it */
static void simple_filter(uint8_t *p, int hstride, int vstride, int thresh) {
  int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

static void filter_loop(uint8_t *p, int hstride, int vstride, int size,
                        int thresh, int ithresh, int hev_t, int edge) {
  int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      do_filter2(p, hstride);
    else if (edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

static void filter_mb(const VP8 *d, const FInfo *f, int mb_x, int mb_y,
                      uint8_t *Y, int ys, uint8_t *U, uint8_t *V, int uvs) {
  int limit = f->limit, il = f->ilevel, ht = f->hev;
  if (limit == 0) return;
  uint8_t *y = Y + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (d->filter_type == 1) {
    if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
    if (f->inner)
      for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
    if (f->inner)
      for (int k = 4; k < 16; k += 4) simple_filter(y + k * ys, ys, 1, limit);
    return;
  }
  uint8_t *u = U + (size_t)mb_y * 8 * uvs + mb_x * 8;
  uint8_t *v = V + (size_t)mb_y * 8 * uvs + mb_x * 8;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, il, ht, 1);
    filter_loop(u, 1, uvs, 8, limit + 4, il, ht, 1);
    filter_loop(v, 1, uvs, 8, limit + 4, il, ht, 1);
  }
  if (f->inner) {
    for (int k = 4; k < 16; k += 4) filter_loop(y + k, 1, ys, 16, limit, il,
                                                ht, 0);
    filter_loop(u + 4, 1, uvs, 8, limit, il, ht, 0);
    filter_loop(v + 4, 1, uvs, 8, limit, il, ht, 0);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, il, ht, 1);
    filter_loop(u, uvs, 1, 8, limit + 4, il, ht, 1);
    filter_loop(v, uvs, 1, 8, limit + 4, il, ht, 1);
  }
  if (f->inner) {
    for (int k = 4; k < 16; k += 4)
      filter_loop(y + k * ys, ys, 1, 16, limit, il, ht, 0);
    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, 0);
    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, 0);
  }
}

typedef struct {
  int is_i4x4, segment, skip, uvmode;
  uint8_t imodes[16];
  int16_t coeffs[384];
  uint32_t non_zero_y, non_zero_uv;
} MBData;

static void parse_intra_mode(VP8 *d, BoolReader *br, uint8_t *top,
                             uint8_t *left, MBData *b) {
  if (d->update_map)
    b->segment = !get_bit(br, d->seg_proba[0])
                     ? get_bit(br, d->seg_proba[1])
                     : get_bit(br, d->seg_proba[2]) + 2;
  else
    b->segment = 0;
  b->skip = d->use_skip ? get_bit(br, d->skip_p) : 0;
  b->is_i4x4 = !get_bit(br, 145);
  if (!b->is_i4x4) {
    int ymode = get_bit(br, 156) ? (get_bit(br, 128) ? B_TM : B_HE)
                                 : (get_bit(br, 163) ? B_VE : B_DC);
    b->imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t *modes = b->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t *prob = BMODES_PROBA + (top[x] * 10 + ymode) * 9;
        int i = YMODES_INTRA4[get_bit(br, prob[0])];
        while (i > 0) i = YMODES_INTRA4[2 * i + get_bit(br, prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  b->uvmode = !get_bit(br, 142)   ? B_DC
              : !get_bit(br, 114) ? B_VE
              : get_bit(br, 183)  ? B_TM
                                  : B_HE;
}

static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

/* the residuals of one macroblock; returns 1 where none is nonzero */
static int parse_residuals(VP8 *d, BoolReader *br, NzCtx *mb, NzCtx *left,
                           MBData *b) {
  const Quant *q = &d->dqm[b->segment];
  int16_t *dst = b->coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  uint8_t (*ac_proba)[3][11];
  memset(dst, 0, 384 * sizeof(*dst));
  if (!b->is_i4x4) {
    int16_t dc[16] = {0};
    int ctx = mb->nz_dc + left->nz_dc;
    int nz = get_coeffs(br, d->proba[1], ctx, q->y2, 0, dc);
    mb->nz_dc = left->nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = d->proba[0];
  } else {
    first = 0;
    ac_proba = d->proba[3];
  }
  uint8_t tnz = mb->nz & 0x0f, lnz = left->nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      int ctx = l + (tnz & 1);
      int nz = get_coeffs(br, ac_proba, ctx, q->y1, first, dst);
      l = nz > first;
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(mb->nz >> (4 + ch));
    lnz = (uint8_t)(left->nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        int ctx = l + (tnz & 1);
        int nz = get_coeffs(br, d->proba[2], ctx, q->uv, 0, dst);
        l = nz > 0;
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb->nz = (uint8_t)out_t_nz;
  left->nz = (uint8_t)out_l_nz;
  b->non_zero_y = non_zero_y;
  b->non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

/* predicts and adds the residuals of one macroblock in the work buffer */
static void reconstruct(const MBData *b, int mb_x, int mb_y, int mb_w,
                        uint8_t *yuv, const uint8_t *top_y,
                        const uint8_t *top_u, const uint8_t *top_v) {
  uint8_t *y_dst = yuv + Y_OFF, *u_dst = yuv + U_OFF, *v_dst = yuv + V_OFF;
  if (mb_x == 0) {
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
  } else {
    for (int j = -1; j < 16; ++j)
      memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
    for (int j = -1; j < 8; ++j) {
      memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
      memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
    }
  }
  if (mb_y > 0) {
    memcpy(y_dst - BPS, top_y + mb_x * 16, 16);
    memcpy(u_dst - BPS, top_u + mb_x * 8, 8);
    memcpy(v_dst - BPS, top_v + mb_x * 8, 8);
  }
  const int16_t *coeffs = b->coeffs;
  uint32_t bits = b->non_zero_y;
  if (b->is_i4x4) {
    uint8_t *top_right = y_dst - BPS + 16;
    if (mb_y > 0) {
      if (mb_x >= mb_w - 1)
        memset(top_right, top_y[mb_x * 16 + 15], 4);
      else
        memcpy(top_right, top_y + (mb_x + 1) * 16, 4);
    }
    for (int k = 1; k <= 3; ++k) memcpy(top_right + k * 4 * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n, bits <<= 2) {
      uint8_t *dst = y_dst + SCAN[n];
      predict4(dst, b->imodes[n]);
      if (bits >> 30) transform_one(coeffs + n * 16, dst);
    }
  } else {
    predict_block(y_dst, check_mode(mb_x, mb_y, b->imodes[0]), 16);
    if (bits)
      for (int n = 0; n < 16; ++n, bits <<= 2)
        if (bits >> 30) transform_one(coeffs + n * 16, y_dst + SCAN[n]);
  }
  int uvmode = check_mode(mb_x, mb_y, b->uvmode);
  predict_block(u_dst, uvmode, 8);
  predict_block(v_dst, uvmode, 8);
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t *dst = ch ? v_dst : u_dst;
    uint32_t uv_bits = b->non_zero_uv >> (8 * ch);
    if (!(uv_bits & 0xff)) continue;
    for (int n = 0; n < 4; ++n)
      transform_one(coeffs + (16 + 4 * ch + n) * 16,
                    dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
  }
}

/* A VP8 key frame (the payload of a "VP8 " chunk, from its frame tag)
 * into planes Y (height x width), U and V ((height + 1) / 2 x
 * (width + 1) / 2). */
int uwt_vp8_decode(const uint8_t *data, int64_t size, int width, int height,
                   uint8_t *out_y, uint8_t *out_u, uint8_t *out_v) {
  if (size < 10) return WEBP_ETRUNC;
  uint32_t tag = data[0] | data[1] << 8 | (uint32_t)data[2] << 16;
  uint32_t part_len = tag >> 5;
  if (tag & 1) return WEBP_EUNSUPPORTED;            /* not a key frame */
  if (((tag >> 1) & 7) > 3) return WEBP_ECORRUPT;   /* profile */
  if (!((tag >> 4) & 1)) return WEBP_EUNSUPPORTED;  /* not shown */
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    return WEBP_ECORRUPT;
  int w = (data[6] | data[7] << 8) & 0x3fff;
  int h = (data[8] | data[9] << 8) & 0x3fff;
  if (w != width || h != height || w == 0 || h == 0) return WEBP_ESIZE;
  if (part_len >= (uint64_t)size) return WEBP_ECORRUPT;
  const uint8_t *buf = data + 10;
  size_t left = (size_t)size - 10;
  if (part_len > left) return WEBP_ETRUNC;
  VP8 *d = calloc(1, sizeof(VP8));
  if (!d) return WEBP_ENOMEM;
  int rc = 0;
  uint8_t *Y = NULL, *U = NULL, *V = NULL, *top = NULL, *intra_t = NULL;
  NzCtx *nz = NULL;
  FInfo *finfo = NULL;
  MBData *b = NULL;
  BoolReader br;
  br_init(&br, buf, part_len);
  buf += part_len;
  left -= part_len;
  d->mb_w = (w + 15) >> 4;
  d->mb_h = (h + 15) >> 4;
  d->absolute_delta = 1;
  memset(d->seg_proba, 255, 3);
  get_value(&br, 1); /* colour space */
  get_value(&br, 1); /* clamping type */
  d->use_segment = get_value(&br, 1);
  if (d->use_segment) {
    d->update_map = get_value(&br, 1);
    if (get_value(&br, 1)) {
      d->absolute_delta = get_value(&br, 1);
      for (int s = 0; s < 4; ++s)
        d->quantizer[s] = get_value(&br, 1) ? get_signed_value(&br, 7) : 0;
      for (int s = 0; s < 4; ++s)
        d->filter_strength[s] =
            get_value(&br, 1) ? get_signed_value(&br, 6) : 0;
    }
    if (d->update_map)
      for (int s = 0; s < 3; ++s)
        d->seg_proba[s] =
            (uint8_t)(get_value(&br, 1) ? get_value(&br, 8) : 255);
  }
  if (br.eof) { rc = WEBP_ECORRUPT; goto done; }
  d->simple = get_value(&br, 1);
  d->level = get_value(&br, 6);
  d->sharpness = get_value(&br, 3);
  d->use_lf_delta = get_value(&br, 1);
  if (d->use_lf_delta && get_value(&br, 1)) {
    for (int i = 0; i < 4; ++i)
      if (get_value(&br, 1)) d->ref_lf_delta[i] = get_signed_value(&br, 6);
    for (int i = 0; i < 4; ++i)
      if (get_value(&br, 1)) d->mode_lf_delta[i] = get_signed_value(&br, 6);
  }
  d->filter_type = d->level == 0 ? 0 : d->simple ? 1 : 2;
  if (br.eof) { rc = WEBP_ECORRUPT; goto done; }
  {
    int last = (1 << get_value(&br, 2)) - 1;
    const uint8_t *sz = buf, *end = buf + left;
    if (left < 3 * (size_t)last) { rc = WEBP_ETRUNC; goto done; }
    const uint8_t *part_start = buf + last * 3;
    size_t size_left = left - last * 3;
    for (int p = 0; p < last; ++p) {
      size_t psize = sz[0] | sz[1] << 8 | (size_t)sz[2] << 16;
      if (psize > size_left) psize = size_left;
      br_init(&d->parts[p], part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    br_init(&d->parts[last], part_start, size_left);
    if (part_start >= end) { rc = WEBP_ETRUNC; goto done; }
    d->num_parts = last + 1;
  }
  parse_quant(d, &br);
  get_value(&br, 1); /* refresh entropy probabilities: ignored */
  for (int t = 0; t < 4; ++t)
    for (int bb = 0; bb < 8; ++bb)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          int i = ((t * 8 + bb) * 3 + c) * 11 + p;
          d->proba[t][bb][c][p] = (uint8_t)(get_bit(&br, COEFFS_UPDATE[i])
                                                ? get_value(&br, 8)
                                                : COEFFS0[i]);
        }
  d->use_skip = get_value(&br, 1);
  if (d->use_skip) d->skip_p = get_value(&br, 8);
  filter_strengths(d);

  int mb_w = d->mb_w, mb_h = d->mb_h;
  int ys = mb_w * 16, uvs = mb_w * 8;
  Y = malloc((size_t)ys * mb_h * 16);
  U = malloc((size_t)uvs * mb_h * 8);
  V = malloc((size_t)uvs * mb_h * 8);
  top = malloc((size_t)mb_w * 32 + YUV_SIZE);
  intra_t = malloc((size_t)mb_w * 4);
  nz = calloc((size_t)mb_w + 1, sizeof(NzCtx));
  finfo = calloc((size_t)mb_w * mb_h, sizeof(FInfo));
  b = malloc(sizeof(MBData));
  if (!Y || !U || !V || !top || !intra_t || !nz || !finfo || !b) {
    rc = WEBP_ENOMEM;
    goto done;
  }
  memset(intra_t, B_DC, (size_t)mb_w * 4);
  uint8_t *top_y = top, *top_u = top + mb_w * 16, *top_v = top_u + mb_w * 8;
  uint8_t *yuv = top + mb_w * 32;
  memset(yuv, 0, YUV_SIZE);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader *token_br = &d->parts[mb_y & (d->num_parts - 1)];
    uint8_t intra_l[4];
    memset(intra_l, B_DC, 4);
    NzCtx *left_nz = &nz[mb_w];
    left_nz->nz = left_nz->nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      parse_intra_mode(d, &br, intra_t + 4 * mb_x, intra_l, b);
      NzCtx *mbn = &nz[mb_x];
      int skip = b->skip;
      if (!skip) {
        skip = parse_residuals(d, token_br, mbn, left_nz, b);
      } else {
        left_nz->nz = mbn->nz = 0;
        if (!b->is_i4x4) left_nz->nz_dc = mbn->nz_dc = 0;
        b->non_zero_y = b->non_zero_uv = 0;
      }
      if (token_br->eof) { rc = WEBP_ETRUNC; goto done; }
      if (d->filter_type > 0) {
        FInfo *f = &finfo[mb_y * mb_w + mb_x];
        *f = d->fstrengths[b->segment][b->is_i4x4];
        f->inner |= !skip;
      }
      reconstruct(b, mb_x, mb_y, mb_w, yuv, top_y, top_u, top_v);
      uint8_t *yd = yuv + Y_OFF, *ud = yuv + U_OFF, *vd = yuv + V_OFF;
      for (int j = 0; j < 16; ++j)
        memcpy(Y + (size_t)(mb_y * 16 + j) * ys + mb_x * 16, yd + j * BPS,
               16);
      for (int j = 0; j < 8; ++j) {
        memcpy(U + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8, ud + j * BPS, 8);
        memcpy(V + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8, vd + j * BPS, 8);
      }
      memcpy(top_y + mb_x * 16, yd + 15 * BPS, 16);
      memcpy(top_u + mb_x * 8, ud + 7 * BPS, 8);
      memcpy(top_v + mb_x * 8, vd + 7 * BPS, 8);
    }
    if (br.eof) { rc = WEBP_ETRUNC; goto done; }
  }
  if (d->filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(d, &finfo[mb_y * mb_w + mb_x], mb_x, mb_y, Y, ys, U, V,
                  uvs);
  for (int j = 0; j < h; ++j) memcpy(out_y + (size_t)j * w, Y + (size_t)j * ys, w);
  int cw = (w + 1) >> 1, ch = (h + 1) >> 1;
  for (int j = 0; j < ch; ++j) {
    memcpy(out_u + (size_t)j * cw, U + (size_t)j * uvs, cw);
    memcpy(out_v + (size_t)j * cw, V + (size_t)j * uvs, cw);
  }
done:
  free(Y);
  free(U);
  free(V);
  free(top);
  free(intra_t);
  free(nz);
  free(finfo);
  free(b);
  free(d);
  return rc;
}

/* ----------------------------------------------------------------- VP8L */

#define NUM_LITERAL_CODES 256
#define NUM_LENGTH_CODES 24
#define NUM_DISTANCE_CODES 40
#define CODE_LENGTH_CODES 19
#define LUT_BITS 8

static const uint8_t CODE_LENGTH_ORDER[CODE_LENGTH_CODES] = {
  17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

/* LSB-first bits, zeros past the end; `consumed` counts the bits read */
typedef struct {
  const uint8_t *buf;
  size_t len, next;
  uint64_t val;
  int avail;
  uint64_t consumed, limit;
} LBits;

static void lb_init(LBits *b, const uint8_t *buf, size_t len) {
  b->buf = buf;
  b->len = len;
  b->next = 0;
  b->val = 0;
  b->avail = 0;
  b->consumed = 0;
  b->limit = len >= 8 ? (uint64_t)len * 8 : 64;
}

static inline void lb_fill(LBits *b) {
  while (b->avail <= 56) {
    uint64_t byte = b->next < b->len ? b->buf[b->next] : 0;
    b->next++;
    b->val |= byte << b->avail;
    b->avail += 8;
  }
}

static inline void lb_skip(LBits *b, int n) {
  b->val >>= n;
  b->avail -= n;
  b->consumed += (uint64_t)n;
}

static inline uint32_t lb_read(LBits *b, int n) {
  if (n == 0) return 0;
  lb_fill(b);
  uint32_t v = (uint32_t)(b->val & ((1ull << n) - 1));
  lb_skip(b, n);
  return v;
}

static inline int lb_eos(const LBits *b) { return b->consumed > b->limit; }

/* a canonical prefix code: codes up to LUT_BITS long decode through `lut`
   ((length << 16) | symbol, 0 for a longer code), the rest bit by bit */
typedef struct {
  uint16_t count[16];
  uint16_t *symbols;  /* by code length, then symbol */
  uint32_t lut[1 << LUT_BITS];
  int single;         /* the symbol of a one-symbol code, else -1 */
} HCode;

static uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1) << (n - 1 - i);
  return r;
}

/* builds the code; 0 where the lengths do not form a complete code (one
   symbol alone is a code of no bits) */
static int build_code(HCode *c, const uint8_t *lengths, int n) {
  memset(c->count, 0, sizeof(c->count));
  memset(c->lut, 0, sizeof(c->lut));
  int used = 0, last = -1;
  for (int s = 0; s < n; ++s)
    if (lengths[s]) {
      c->count[lengths[s]]++;
      used++;
      last = s;
    }
  c->single = -1;
  if (used == 1) {
    c->single = last;
    return 1;
  }
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= c->count[len];
    if (left < 0) return 0;
  }
  if (left != 0) return 0;
  uint16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + c->count[len];
  for (int s = 0; s < n; ++s)
    if (lengths[s]) c->symbols[offs[lengths[s]]++] = (uint16_t)s;
  /* the LUT: canonical codes in order of length, then symbol */
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= LUT_BITS; ++len) {
    for (int i = 0; i < c->count[len]; ++i, ++k, ++code) {
      uint32_t r = reverse_bits(code, len);
      for (uint32_t j = r; j < (1u << LUT_BITS); j += 1u << len)
        c->lut[j] = ((uint32_t)len << 16) | c->symbols[k];
    }
    code <<= 1;
  }
  return 1;
}

static int read_symbol(const HCode *c, LBits *b) {
  if (c->single >= 0) return c->single;
  lb_fill(b);
  uint32_t e = c->lut[b->val & ((1u << LUT_BITS) - 1)];
  if (e) {
    lb_skip(b, (int)(e >> 16));
    return (int)(e & 0xffff);
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= (int)(b->val & 1);
    lb_skip(b, 1);
    int count = c->count[len];
    if (code - count < first) return c->symbols[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return 0; /* not reached for a complete code */
}

/* one prefix code of `alphabet` symbols from the stream */
static int read_code(LBits *b, HCode *c, int alphabet, uint8_t *lengths) {
  memset(lengths, 0, alphabet);
  if (lb_read(b, 1)) { /* simple */
    int num = lb_read(b, 1) + 1;
    int first_bits = lb_read(b, 1) ? 8 : 1;
    int s = (int)lb_read(b, first_bits);
    if (s < alphabet) lengths[s] = 1;
    if (num == 2) {
      s = (int)lb_read(b, 8);
      if (s < alphabet) lengths[s] = 1;
    }
  } else {
    uint8_t cl_lengths[CODE_LENGTH_CODES] = {0};
    uint16_t cl_symbols[CODE_LENGTH_CODES];
    HCode cl;
    cl.symbols = cl_symbols;
    int num = (int)lb_read(b, 4) + 4;
    for (int i = 0; i < num; ++i)
      cl_lengths[CODE_LENGTH_ORDER[i]] = (uint8_t)lb_read(b, 3);
    if (!build_code(&cl, cl_lengths, CODE_LENGTH_CODES)) return 0;
    int max_symbol;
    if (lb_read(b, 1)) {
      int nbits = 2 + 2 * (int)lb_read(b, 3);
      max_symbol = 2 + (int)lb_read(b, nbits);
      if (max_symbol > alphabet) return 0;
    } else {
      max_symbol = alphabet;
    }
    int prev = 8, s = 0;
    while (s < alphabet) {
      if (max_symbol-- == 0) break;
      int len = read_symbol(&cl, b);
      if (len < 16) {
        lengths[s++] = (uint8_t)len;
        if (len) prev = len;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int slot = len - 16;
        int repeat = (int)lb_read(b, extra[slot]) + offset[slot];
        if (s + repeat > alphabet) return 0;
        int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[s++] = (uint8_t)v;
      }
    }
  }
  if (lb_eos(b)) return 0;
  return build_code(c, lengths, alphabet);
}

typedef struct {
  HCode codes[5]; /* green + lengths + cache, red, blue, alpha, distance */
} HGroup;

typedef struct {
  int type, bits, xsize;
  uint32_t *data;
} Transform;

typedef struct {
  LBits br;
  Transform transforms[4];
  int ntransforms, seen;
} VP8L;

static int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

static int decode_stream(VP8L *d, int xsize, int ysize, int level0,
                         uint32_t **out);

static void free_groups(HGroup *g, int n) {
  if (!g) return;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 5; ++j) free(g[i].codes[j].symbols);
  free(g);
}

static int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int dist_code = PLANE_CODES[code - 1];
  int yoff = dist_code >> 4, xoff = 8 - (dist_code & 0xf);
  int dist = yoff * xsize + xoff;
  return dist >= 1 ? dist : 1;
}

static int prefix_value(int symbol, LBits *b) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)lb_read(b, extra) + 1;
}

/* the entropy-coded image of xsize x ysize into `data` */
static int decode_pixels(VP8L *d, uint32_t *data, int xsize, int ysize,
                         HGroup *groups, const uint32_t *meta, int meta_bits,
                         int cache_bits) {
  LBits *b = &d->br;
  uint32_t cache[1 << 11];
  int cache_size = cache_bits ? 1 << cache_bits : 0;
  if (cache_size) memset(cache, 0, sizeof(uint32_t) * cache_size);
  int meta_xsize = meta_bits ? subsample(xsize, meta_bits) : 0;
  size_t total = (size_t)xsize * ysize, pos = 0, cached = 0;
  int x = 0, y = 0;
  while (pos < total) {
    const HGroup *g =
        groups + (meta_bits ? meta[(y >> meta_bits) * meta_xsize +
                                   (x >> meta_bits)]
                            : 0);
    int code = read_symbol(&g->codes[0], b);
    if (code < NUM_LITERAL_CODES) {
      int red = read_symbol(&g->codes[1], b);
      int blue = read_symbol(&g->codes[2], b);
      int alpha = read_symbol(&g->codes[3], b);
      data[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                    ((uint32_t)code << 8) | (uint32_t)blue;
      if (++x >= xsize) {
        x = 0;
        ++y;
      }
    } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES) {
      int length = prefix_value(code - NUM_LITERAL_CODES, b);
      int dist_symbol = read_symbol(&g->codes[4], b);
      int dist = plane_to_distance(xsize, prefix_value(dist_symbol, b));
      if (lb_eos(b)) return WEBP_ETRUNC;
      if ((size_t)dist > pos || total - pos < (size_t)length)
        return WEBP_ECORRUPT;
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      x += length;
      while (x >= xsize) {
        x -= xsize;
        ++y;
      }
    } else {
      int key = code - NUM_LITERAL_CODES - NUM_LENGTH_CODES;
      if (key >= cache_size) return WEBP_ECORRUPT;
      for (; cached < pos; ++cached)
        cache[(uint32_t)(data[cached] * 0x1e35a7bdu) >> (32 - cache_bits)] =
            data[cached];
      data[pos++] = cache[key];
      if (++x >= xsize) {
        x = 0;
        ++y;
      }
    }
    if (cache_size)
      for (; cached < pos; ++cached)
        cache[(uint32_t)(data[cached] * 0x1e35a7bdu) >> (32 - cache_bits)] =
            data[cached];
    if (lb_eos(b)) return WEBP_ETRUNC;
  }
  return lb_eos(b) ? WEBP_ETRUNC : 0;
}

static int read_transform(VP8L *d, int *xsize, int ysize) {
  LBits *b = &d->br;
  int type = (int)lb_read(b, 2);
  if (d->seen & (1 << type)) return WEBP_ECORRUPT;
  d->seen |= 1 << type;
  Transform *t = &d->transforms[d->ntransforms++];
  t->type = type;
  t->xsize = *xsize;
  t->data = NULL;
  t->bits = 0;
  int rc = 0;
  if (type == 0 || type == 1) { /* predictor, cross-colour */
    t->bits = (int)lb_read(b, 3) + 2;
    rc = decode_stream(d, subsample(*xsize, t->bits),
                       subsample(ysize, t->bits), 0, &t->data);
  } else if (type == 3) { /* colour indexing */
    int num = (int)lb_read(b, 8) + 1;
    int bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
    *xsize = subsample(t->xsize, bits);
    t->bits = bits;
    uint32_t *pal = NULL;
    rc = decode_stream(d, num, 1, 0, &pal);
    if (rc == 0) {
      int final = 1 << (8 >> bits);
      t->data = calloc((size_t)final, sizeof(uint32_t));
      if (!t->data) {
        free(pal);
        return WEBP_ENOMEM;
      }
      uint8_t *src = (uint8_t *)pal, *dst = (uint8_t *)t->data;
      memcpy(dst, src, 4);
      for (int i = 4; i < 4 * num; ++i)
        dst[i] = (uint8_t)(src[i] + dst[i - 4]);
    }
    free(pal);
  }
  return rc;
}

/* the prefix codes of an image: one group, or the entropy image's groups
   where level0 and the stream says so */
static int read_codes(VP8L *d, int xsize, int ysize, int cache_bits,
                      int level0, HGroup **groups_out, int *ngroups_out,
                      uint32_t **meta_out, int *meta_bits_out) {
  LBits *b = &d->br;
  uint32_t *meta = NULL;
  int meta_bits = 0, ngroups = 1;
  if (level0 && lb_read(b, 1)) {
    meta_bits = (int)lb_read(b, 3) + 2;
    int mw = subsample(xsize, meta_bits), mh = subsample(ysize, meta_bits);
    int rc = decode_stream(d, mw, mh, 0, &meta);
    if (rc) return rc;
    for (size_t i = 0; i < (size_t)mw * mh; ++i) {
      meta[i] = (meta[i] >> 8) & 0xffff;
      if ((int)meta[i] >= ngroups) ngroups = (int)meta[i] + 1;
    }
  }
  /* codes of groups no pixel uses are read and checked, then dropped */
  uint8_t *used = malloc((size_t)ngroups);
  if (used) {
    memset(used, meta ? 0 : 1, (size_t)ngroups);
    if (meta)
      for (size_t i = 0; i < (size_t)subsample(xsize, meta_bits) *
                                 subsample(ysize, meta_bits); ++i)
        used[meta[i]] = 1;
  }
  HGroup *groups = calloc((size_t)ngroups, sizeof(HGroup));
  int max_alphabet = NUM_LITERAL_CODES + NUM_LENGTH_CODES +
                     (cache_bits ? 1 << cache_bits : 0);
  uint8_t *lengths = malloc((size_t)max_alphabet);
  if (!groups || !lengths || !used) {
    free(used);
    free(groups);
    free(lengths);
    free(meta);
    return WEBP_ENOMEM;
  }
  static const int sizes[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES,
                               NUM_LITERAL_CODES, NUM_LITERAL_CODES,
                               NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
  int rc = 0;
  for (int i = 0; i < ngroups && rc == 0; ++i)
    for (int j = 0; j < 5 && rc == 0; ++j) {
      int alphabet = sizes[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      HCode *c = &groups[i].codes[j];
      c->symbols = malloc(sizeof(uint16_t) * (size_t)alphabet);
      if (!c->symbols)
        rc = WEBP_ENOMEM;
      else if (!read_code(b, c, alphabet, lengths))
        rc = lb_eos(b) ? WEBP_ETRUNC : WEBP_ECORRUPT;
      if (!used[i]) {
        free(c->symbols);
        c->symbols = NULL;
      }
    }
  free(lengths);
  free(used);
  if (rc) {
    free_groups(groups, ngroups);
    free(meta);
    return rc;
  }
  *groups_out = groups;
  *ngroups_out = ngroups;
  *meta_out = meta;
  *meta_bits_out = meta_bits;
  return 0;
}

static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

static inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static inline int sub3(int a, int b, int c) {
  return abs(b - c) - abs(a - c);
}

static inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = sub3((int)(a >> 24), (int)(b >> 24), (int)(c >> 24)) +
                    sub3((int)((a >> 16) & 0xff), (int)((b >> 16) & 0xff),
                         (int)((c >> 16) & 0xff)) +
                    sub3((int)((a >> 8) & 0xff), (int)((b >> 8) & 0xff),
                         (int)((c >> 8) & 0xff)) +
                    sub3((int)(a & 0xff), (int)(b & 0xff), (int)(c & 0xff));
  return pa_minus_pb <= 0 ? a : b;
}

static inline uint32_t clip255(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : (uint32_t)v;
}

static uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                   (int)((c2 >> s) & 0xff)) << s;
  return out;
}

static uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = average2(c0, c1), out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
    out |= clip255(a + (a - b) / 2) << s;
  }
  return out;
}

static uint32_t predict(int mode, const uint32_t *out, int x, int width) {
  uint32_t L = out[x - 1];
  const uint32_t *up = out + x - width;
  switch (mode) {
    case 1: return L;
    case 2: return up[0];
    case 3: return up[1];
    case 4: return up[-1];
    case 5: return average2(average2(L, up[1]), up[0]);
    case 6: return average2(L, up[-1]);
    case 7: return average2(L, up[0]);
    case 8: return average2(up[-1], up[0]);
    case 9: return average2(up[0], up[1]);
    case 10: return average2(average2(L, up[-1]), average2(up[0], up[1]));
    case 11: return select_pred(up[0], L, up[-1]);
    case 12: return add_sub_full(L, up[0], up[-1]);
    case 13: return add_sub_half(L, up[0], up[-1]);
    default: return 0xff000000u;
  }
}

static inline int color_delta(int8_t pred, int8_t color) {
  return ((int)pred * color) >> 5;
}

/* undoes one transform: `in` is the image the transform made (its packed
   width for colour indexing), `out` the full width x height */
static void inverse_transform(const Transform *t, int height,
                              const uint32_t *in, uint32_t *out) {
  int width = t->xsize;
  size_t n = (size_t)width * height;
  if (t->type == 2) { /* subtract green */
    for (size_t i = 0; i < n; ++i) {
      uint32_t argb = in[i], g = (argb >> 8) & 0xff;
      uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      out[i] = (argb & 0xff00ff00u) | rb;
    }
  } else if (t->type == 0) { /* predictor */
    int tiles = subsample(width, t->bits);
    out[0] = add_pixels(in[0], 0xff000000u);
    for (int x = 1; x < width; ++x) out[x] = add_pixels(in[x], out[x - 1]);
    for (int y = 1; y < height; ++y) {
      uint32_t *row = out + (size_t)y * width;
      const uint32_t *src = in + (size_t)y * width;
      const uint32_t *modes = t->data + (size_t)(y >> t->bits) * tiles;
      row[0] = add_pixels(src[0], row[-width]);
      for (int x = 1; x < width; ++x) {
        int mode = (modes[x >> t->bits] >> 8) & 0xf;
        row[x] = add_pixels(src[x], predict(mode, row, x, width));
      }
    }
  } else if (t->type == 1) { /* cross colour */
    int tiles = subsample(width, t->bits);
    for (int y = 0; y < height; ++y) {
      const uint32_t *codes = t->data + (size_t)(y >> t->bits) * tiles;
      for (int x = 0; x < width; ++x) {
        uint32_t m = codes[x >> t->bits];
        int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff);
        int8_t r2b = (int8_t)((m >> 16) & 0xff);
        uint32_t argb = in[(size_t)y * width + x];
        int8_t green = (int8_t)(argb >> 8);
        int new_red = (int)((argb >> 16) & 0xff);
        int new_blue = (int)(argb & 0xff);
        new_red += color_delta(g2r, green);
        new_red &= 0xff;
        new_blue += color_delta(g2b, green);
        new_blue += color_delta(r2b, (int8_t)new_red);
        new_blue &= 0xff;
        out[(size_t)y * width + x] =
            (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) |
            (uint32_t)new_blue;
      }
    }
  } else { /* colour indexing */
    int bits_per_pixel = 8 >> t->bits, per_byte = 1 << t->bits;
    uint32_t mask = (1u << bits_per_pixel) - 1;
    int packed_w = subsample(width, t->bits);
    for (int y = 0; y < height; ++y) {
      const uint32_t *src = in + (size_t)y * packed_w;
      uint32_t *dst = out + (size_t)y * width;
      uint32_t packed = 0;
      for (int x = 0; x < width; ++x) {
        if ((x & (per_byte - 1)) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t->data[packed & mask];
        packed >>= bits_per_pixel;
      }
    }
  }
}

static int decode_stream(VP8L *d, int xsize, int ysize, int level0,
                         uint32_t **out) {
  LBits *b = &d->br;
  int txsize = xsize, rc = 0;
  if (level0)
    while (rc == 0 && lb_read(b, 1)) {
      if (d->ntransforms >= 4) return WEBP_ECORRUPT;
      rc = read_transform(d, &txsize, ysize);
    }
  if (rc) return rc;
  int cache_bits = 0;
  if (lb_read(b, 1)) {
    cache_bits = (int)lb_read(b, 4);
    if (cache_bits < 1 || cache_bits > 11) return WEBP_ECORRUPT;
  }
  HGroup *groups = NULL;
  uint32_t *meta = NULL;
  int ngroups = 0, meta_bits = 0;
  rc = read_codes(d, txsize, ysize, cache_bits, level0, &groups, &ngroups,
                  &meta, &meta_bits);
  if (rc) return rc;
  uint32_t *data = malloc(sizeof(uint32_t) * (size_t)txsize * ysize);
  if (!data) {
    rc = WEBP_ENOMEM;
  } else {
    rc = decode_pixels(d, data, txsize, ysize, groups, meta, meta_bits,
                       cache_bits);
  }
  free_groups(groups, ngroups);
  free(meta);
  if (rc) {
    free(data);
    return rc;
  }
  if (level0) {
    for (int i = d->ntransforms - 1; i >= 0; --i) {
      const Transform *t = &d->transforms[i];
      uint32_t *next = malloc(sizeof(uint32_t) * (size_t)t->xsize * ysize);
      if (!next) {
        free(data);
        return WEBP_ENOMEM;
      }
      inverse_transform(t, ysize, data, next);
      free(data);
      data = next;
    }
  }
  *out = data;
  return 0;
}

static int vp8l_run(const uint8_t *data, int64_t size, int width, int height,
                    int headerless, uint32_t *argb) {
  VP8L *d = calloc(1, sizeof(VP8L));
  if (!d) return WEBP_ENOMEM;
  lb_init(&d->br, data, (size_t)size);
  int rc = 0;
  if (!headerless) {
    if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) {
      free(d);
      return WEBP_ECORRUPT;
    }
    lb_read(&d->br, 8);
    int w = (int)lb_read(&d->br, 14) + 1, h = (int)lb_read(&d->br, 14) + 1;
    lb_read(&d->br, 1); /* alpha hint */
    lb_read(&d->br, 3); /* version */
    if (w != width || h != height) rc = WEBP_ESIZE;
  }
  uint32_t *out = NULL;
  if (rc == 0) rc = decode_stream(d, width, height, 1, &out);
  if (rc == 0) memcpy(argb, out, sizeof(uint32_t) * (size_t)width * height);
  free(out);
  for (int i = 0; i < d->ntransforms; ++i) free(d->transforms[i].data);
  free(d);
  return rc;
}

/* A VP8L image (the payload of a "VP8L" chunk, from its signature byte)
 * into ARGB (height x width uint32). */
int uwt_vp8l_decode(const uint8_t *data, int64_t size, int width, int height,
                    uint32_t *argb) {
  return vp8l_run(data, size, width, height, 0, argb);
}

/* An ALPH chunk's payload into alpha (height x width bytes). */
int uwt_webp_alpha(const uint8_t *data, int64_t size, int width, int height,
                   uint8_t *alpha) {
  if (size <= 1) return WEBP_ETRUNC;
  int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  int pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) return WEBP_ECORRUPT;
  size_t n = (size_t)width * height;
  if (method == 0) {
    if ((size_t)(size - 1) < n) return WEBP_ETRUNC;
    memcpy(alpha, data + 1, n);
  } else {
    uint32_t *argb = malloc(sizeof(uint32_t) * n);
    if (!argb) return WEBP_ENOMEM;
    int rc = vp8l_run(data + 1, size - 1, width, height, 1, argb);
    if (rc == 0)
      for (size_t i = 0; i < n; ++i) alpha[i] = (uint8_t)(argb[i] >> 8);
    free(argb);
    if (rc) return rc;
  }
  for (int y = 0; y < height; ++y) {
    uint8_t *row = alpha + (size_t)y * width;
    const uint8_t *prev = y ? row - width : NULL;
    if (filter == 0) continue;
    if (filter == 1 || !prev) { /* horizontal; every filter's first row */
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (filter == 2) { /* vertical */
      for (int x = 0; x < width; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else { /* gradient */
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        int g = left + top - top_left;
        g = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = (uint8_t)(row[x] + g);
        top_left = top;
        row[x] = left;
      }
    }
  }
  return 0;
}

/* ------------------------------------------- VP8 writer (test data only) */

/* RFC 6386's boolean encoder, into a caller's buffer */
typedef struct {
  uint8_t *buf;
  int64_t pos, cap;
  uint32_t range, bottom;
  int bit_count, overflow;
} BoolWriter;

static void bw_init(BoolWriter *e, uint8_t *buf, int64_t cap) {
  e->buf = buf;
  e->pos = 0;
  e->cap = cap;
  e->range = 255;
  e->bottom = 0;
  e->bit_count = 24;
  e->overflow = 0;
}

static void bw_carry(BoolWriter *e) {
  int64_t q = e->pos;
  while (q > 0 && e->buf[q - 1] == 255) e->buf[--q] = 0;
  if (q > 0) e->buf[q - 1]++;
}

static void bw_byte(BoolWriter *e, uint8_t v) {
  if (e->pos < e->cap)
    e->buf[e->pos++] = v;
  else
    e->overflow = 1;
}

static void put_bit(BoolWriter *e, int bit, int prob) {
  uint32_t split = 1 + (((e->range - 1) * (uint32_t)prob) >> 8);
  if (bit) {
    e->bottom += split;
    e->range -= split;
  } else {
    e->range = split;
  }
  while (e->range < 128) {
    e->range <<= 1;
    if (e->bottom & (1u << 31)) bw_carry(e);
    e->bottom <<= 1;
    if (!--e->bit_count) {
      bw_byte(e, (uint8_t)(e->bottom >> 24));
      e->bottom &= (1 << 24) - 1;
      e->bit_count = 8;
    }
  }
}

static void bw_flush(BoolWriter *e) {
  int c = e->bit_count;
  uint32_t v = e->bottom;
  if (v & (1u << (32 - c))) bw_carry(e);
  v <<= c & 7;
  c >>= 3;
  while (--c >= 0) v <<= 8;
  for (c = 0; c < 4; ++c) {
    bw_byte(e, (uint8_t)(v >> 24));
    v <<= 8;
  }
}

static void put_value(BoolWriter *e, int v, int nbits) {
  while (nbits-- > 0) put_bit(e, (v >> nbits) & 1, 0x80);
}

static void put_signed_value(BoolWriter *e, int v, int nbits) {
  put_value(e, v < 0 ? -v : v, nbits);
  put_bit(e, v < 0, 0x80);
}

static void put_flagged(BoolWriter *e, int v, int nbits) {
  put_bit(e, v != 0, 0x80);
  if (v) put_signed_value(e, v, nbits);
}

/* one block's levels (zigzag order) from position `first`; returns 1
   where any is nonzero */
static int put_coeffs(BoolWriter *e, uint8_t (*const bands)[3][11], int ctx,
                      int first, const int16_t *zz) {
  int last = -1;
  for (int n = first; n < 16; ++n)
    if (zz[n]) last = n;
  int n = first;
  const uint8_t *p = bands[BANDS[n]][ctx];
  for (;;) {
    if (n > last) {
      if (n < 16) put_bit(e, 0, p[0]);
      return last >= first;
    }
    put_bit(e, 1, p[0]);
    while (zz[n] == 0) {
      put_bit(e, 0, p[1]);
      p = bands[BANDS[++n]][0];
    }
    put_bit(e, 1, p[1]);
    int v = zz[n] < 0 ? -zz[n] : zz[n];
    if (v == 1) {
      put_bit(e, 0, p[2]);
      p = bands[BANDS[n + 1]][1];
    } else {
      put_bit(e, 1, p[2]);
      if (v <= 4) {
        put_bit(e, 0, p[3]);
        put_bit(e, v > 2, p[4]);
        if (v > 2) put_bit(e, v - 3, p[5]);
      } else if (v <= 10) {
        put_bit(e, 1, p[3]);
        put_bit(e, 0, p[6]);
        put_bit(e, v > 6, p[7]);
        if (v <= 6) {
          put_bit(e, v - 5, 159);
        } else {
          put_bit(e, (v - 7) >> 1, 165);
          put_bit(e, (v - 7) & 1, 145);
        }
      } else {
        int cat = v < 19 ? 0 : v < 35 ? 1 : v < 67 ? 2 : 3;
        int extra = v - (3 + (8 << cat)), len = 0;
        const uint8_t *tab = CAT3456[cat];
        while (tab[len]) len++;
        put_bit(e, 1, p[3]);
        put_bit(e, 1, p[6]);
        put_bit(e, cat >> 1, p[8]);
        put_bit(e, cat & 1, p[9 + (cat >> 1)]);
        for (int i = 0; i < len; ++i)
          put_bit(e, (extra >> (len - 1 - i)) & 1, tab[i]);
      }
      p = bands[BANDS[n + 1]][2];
    }
    put_bit(e, zz[n] < 0, 0x80);
    if (++n == 16) return 1;
  }
}

/* each 4x4 mode's path down YMODES_INTRA4: its bits (first bit highest),
   their count and the node (probability) of each */
static const uint8_t BMODE_BITS[10] = {0x0, 0x2, 0x6, 0x1c, 0x3a, 0x3b,
                                       0x1e, 0x3e, 0x7e, 0x7f};
static const uint8_t BMODE_LEN[10] = {1, 2, 3, 5, 6, 6, 5, 6, 7, 7};
static const uint8_t BMODE_NODES[10][7] = {
  {0}, {0, 1}, {0, 1, 2}, {0, 1, 2, 3, 4}, {0, 1, 2, 3, 4, 5},
  {0, 1, 2, 3, 4, 5}, {0, 1, 2, 3, 6}, {0, 1, 2, 3, 6, 7},
  {0, 1, 2, 3, 6, 7, 8}, {0, 1, 2, 3, 6, 7, 8}};

enum {
  H_W, H_H, H_LOG2PARTS, H_USE_SEGMENT, H_UPDATE_MAP, H_ABSOLUTE,
  H_SEG_Q, H_SEG_LF = H_SEG_Q + 4, H_SEG_PROBA = H_SEG_LF + 4,
  H_SIMPLE = H_SEG_PROBA + 3, H_LEVEL, H_SHARPNESS, H_USE_LF_DELTA,
  H_REF_LF, H_MODE_LF = H_REF_LF + 4, H_BASE_Q = H_MODE_LF + 4,
  H_DQ, H_USE_SKIP = H_DQ + 5, H_SKIP_P, H_COUNT
};
#define MB_BYTES 21 /* segment, skip, is_i4x4, ymode, uvmode, 16 4x4 modes */

/* A VP8 key frame of the given header fields, per-macroblock modes
 * (MB_BYTES each, raster order) and quantized levels (25 blocks of 16 a
 * macroblock, zigzag order: 16 Y, 4 U, 4 V, then Y2), coded with the
 * default probabilities; returns its size, or WEBP_ENOMEM where `cap` is
 * too small. */
int64_t uwt_vp8_encode(const int32_t *hdr, const uint8_t *mbs,
                       const int16_t *levels, uint8_t *out, int64_t cap) {
  int w = hdr[H_W], h = hdr[H_H], nparts = 1 << hdr[H_LOG2PARTS];
  int mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
  int64_t part_cap = cap;
  uint8_t *scratch = malloc((size_t)part_cap * (nparts + 1));
  uint8_t *intra_t = malloc((size_t)mb_w * 4);
  NzCtx *nz = calloc((size_t)mb_w + 1, sizeof(NzCtx));
  uint8_t (*proba)[8][3][11] = malloc(sizeof(uint8_t) * 4 * 8 * 3 * 11);
  if (!scratch || !intra_t || !nz || !proba) {
    free(scratch);
    free(intra_t);
    free(nz);
    free(proba);
    return WEBP_ENOMEM;
  }
  memcpy(proba, COEFFS0, sizeof(COEFFS0));
  BoolWriter e0, parts[8];
  bw_init(&e0, scratch, part_cap);
  for (int p = 0; p < nparts; ++p)
    bw_init(&parts[p], scratch + part_cap * (p + 1), part_cap);
  put_value(&e0, 0, 1); /* colour space */
  put_value(&e0, 0, 1); /* clamping */
  put_value(&e0, hdr[H_USE_SEGMENT], 1);
  if (hdr[H_USE_SEGMENT]) {
    put_value(&e0, hdr[H_UPDATE_MAP], 1);
    put_value(&e0, 1, 1); /* update the segment data */
    put_value(&e0, hdr[H_ABSOLUTE], 1);
    for (int s = 0; s < 4; ++s) put_flagged(&e0, hdr[H_SEG_Q + s], 7);
    for (int s = 0; s < 4; ++s) put_flagged(&e0, hdr[H_SEG_LF + s], 6);
    if (hdr[H_UPDATE_MAP])
      for (int s = 0; s < 3; ++s) {
        int pr = hdr[H_SEG_PROBA + s];
        put_bit(&e0, pr != 255, 0x80);
        if (pr != 255) put_value(&e0, pr, 8);
      }
  }
  put_value(&e0, hdr[H_SIMPLE], 1);
  put_value(&e0, hdr[H_LEVEL], 6);
  put_value(&e0, hdr[H_SHARPNESS], 3);
  put_value(&e0, hdr[H_USE_LF_DELTA], 1);
  if (hdr[H_USE_LF_DELTA]) {
    put_value(&e0, 1, 1);
    for (int i = 0; i < 4; ++i) put_flagged(&e0, hdr[H_REF_LF + i], 6);
    for (int i = 0; i < 4; ++i) put_flagged(&e0, hdr[H_MODE_LF + i], 6);
  }
  put_value(&e0, hdr[H_LOG2PARTS], 2);
  put_value(&e0, hdr[H_BASE_Q], 7);
  for (int i = 0; i < 5; ++i) put_flagged(&e0, hdr[H_DQ + i], 4);
  put_value(&e0, 0, 1); /* refresh entropy probabilities */
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i) put_bit(&e0, 0, COEFFS_UPDATE[i]);
  put_value(&e0, hdr[H_USE_SKIP], 1);
  if (hdr[H_USE_SKIP]) put_value(&e0, hdr[H_SKIP_P], 8);
  memset(intra_t, B_DC, (size_t)mb_w * 4);
  static const uint8_t ymode_bits[4][3] = {
      /* B_DC, B_TM, B_VE, B_HE: (bit 156, bit 128 or 163) */
      {0, 0, 0}, {1, 1, 0}, {0, 1, 0}, {1, 0, 0}};
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolWriter *tw = &parts[mb_y & (nparts - 1)];
    uint8_t intra_l[4];
    memset(intra_l, B_DC, 4);
    NzCtx *left = &nz[mb_w];
    left->nz = left->nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const uint8_t *m = mbs + (size_t)(mb_y * mb_w + mb_x) * MB_BYTES;
      const int16_t *lv = levels + (size_t)(mb_y * mb_w + mb_x) * 25 * 16;
      uint8_t *top = intra_t + 4 * mb_x;
      int seg = m[0], skip = m[1], i4 = m[2], ymode = m[3], uv = m[4];
      if (hdr[H_UPDATE_MAP] && hdr[H_USE_SEGMENT]) {
        put_bit(&e0, seg >> 1, hdr[H_SEG_PROBA + 0]);
        put_bit(&e0, seg & 1, hdr[H_SEG_PROBA + 1 + (seg >> 1)]);
      }
      if (hdr[H_USE_SKIP]) put_bit(&e0, skip, hdr[H_SKIP_P]);
      put_bit(&e0, !i4, 145);
      if (!i4) {
        const uint8_t *b = ymode_bits[ymode];
        put_bit(&e0, b[0], 156);
        put_bit(&e0, b[1], b[0] ? 128 : 163);
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int lmode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            int mode = m[5 + y * 4 + x];
            const uint8_t *prob = BMODES_PROBA + (top[x] * 10 + lmode) * 9;
            for (int k = 0; k < BMODE_LEN[mode]; ++k)
              put_bit(&e0, (BMODE_BITS[mode] >> (BMODE_LEN[mode] - 1 - k)) & 1,
                      prob[BMODE_NODES[mode][k]]);
            lmode = mode;
            top[x] = (uint8_t)mode;
          }
          intra_l[y] = (uint8_t)lmode;
        }
      }
      put_bit(&e0, uv != B_DC, 142);
      if (uv != B_DC) {
        put_bit(&e0, uv != B_VE, 114);
        if (uv != B_VE) put_bit(&e0, uv == B_TM, 183);
      }
      NzCtx *mbn = &nz[mb_x];
      if (skip && hdr[H_USE_SKIP]) {
        left->nz = mbn->nz = 0;
        if (!i4) left->nz_dc = mbn->nz_dc = 0;
        continue;
      }
      int first = 0;
      uint8_t (*ac)[3][11] = proba[3];
      if (!i4) {
        int l = put_coeffs(tw, proba[1], mbn->nz_dc + left->nz_dc, 0,
                           lv + 24 * 16);
        mbn->nz_dc = left->nz_dc = (uint8_t)l;
        first = 1;
        ac = proba[0];
      }
      uint8_t tnz = mbn->nz & 0x0f, lnz = left->nz & 0x0f;
      for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 4; ++x) {
          l = put_coeffs(tw, ac, l + (tnz & 1), first, lv + (y * 4 + x) * 16);
          tnz = (uint8_t)((tnz >> 1) | (l << 7));
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
      }
      uint32_t out_t = tnz, out_l = lnz >> 4;
      for (int ch = 0; ch < 4; ch += 2) {
        tnz = (uint8_t)(mbn->nz >> (4 + ch));
        lnz = (uint8_t)(left->nz >> (4 + ch));
        for (int y = 0; y < 2; ++y) {
          int l = lnz & 1;
          for (int x = 0; x < 2; ++x) {
            l = put_coeffs(tw, proba[2], l + (tnz & 1), 0,
                           lv + (16 + 2 * ch + y * 2 + x) * 16);
            tnz = (uint8_t)((tnz >> 1) | (l << 3));
          }
          tnz >>= 2;
          lnz = (uint8_t)((lnz >> 1) | (l << 5));
        }
        out_t |= (uint32_t)(tnz << 4) << ch;
        out_l |= (uint32_t)(lnz & 0xf0) << ch;
      }
      mbn->nz = (uint8_t)out_t;
      left->nz = (uint8_t)out_l;
    }
  }
  bw_flush(&e0);
  for (int p = 0; p < nparts; ++p) bw_flush(&parts[p]);
  int64_t rc = WEBP_ENOMEM, size = 10 + e0.pos + 3 * (nparts - 1);
  for (int p = 0; p < nparts; ++p) size += parts[p].pos;
  int overflow = e0.overflow;
  for (int p = 0; p < nparts; ++p) overflow |= parts[p].overflow;
  if (!overflow && size <= cap && e0.pos < (1 << 19)) {
    uint32_t tag = 0 | (0 << 1) | (1 << 4) | ((uint32_t)e0.pos << 5);
    uint8_t *o = out;
    *o++ = (uint8_t)tag;
    *o++ = (uint8_t)(tag >> 8);
    *o++ = (uint8_t)(tag >> 16);
    *o++ = 0x9d;
    *o++ = 0x01;
    *o++ = 0x2a;
    *o++ = (uint8_t)w;
    *o++ = (uint8_t)(w >> 8);
    *o++ = (uint8_t)h;
    *o++ = (uint8_t)(h >> 8);
    memcpy(o, e0.buf, (size_t)e0.pos);
    o += e0.pos;
    for (int p = 0; p < nparts - 1; ++p) {
      *o++ = (uint8_t)parts[p].pos;
      *o++ = (uint8_t)(parts[p].pos >> 8);
      *o++ = (uint8_t)(parts[p].pos >> 16);
    }
    for (int p = 0; p < nparts; ++p) {
      memcpy(o, parts[p].buf, (size_t)parts[p].pos);
      o += parts[p].pos;
    }
    rc = size;
  }
  free(scratch);
  free(intra_t);
  free(nz);
  free(proba);
  return rc;
}

/* Packs n (code, length) pairs least significant bit first, as VP8L
 * streams are read (a prefix code's bits reversed by the caller); returns
 * the bytes written or WEBP_ENOMEM where `cap` is too small. */
int64_t uwt_pack_bits_lsb(const uint32_t *codes, const uint8_t *lengths,
                          int64_t n, uint8_t *out, int64_t cap) {
  uint64_t acc = 0;
  int used = 0;
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    acc |= (uint64_t)codes[i] << used;
    used += lengths[i];
    while (used >= 8) {
      if (pos >= cap) return WEBP_ENOMEM;
      out[pos++] = (uint8_t)acc;
      acc >>= 8;
      used -= 8;
    }
  }
  if (used) {
    if (pos >= cap) return WEBP_ENOMEM;
    out[pos++] = (uint8_t)acc;
  }
  return pos;
}
