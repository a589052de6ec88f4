// Hopper (sm_90a) int8 convolution of the int8 inference tier, with a plain
// C interface for ctypes (ops/kernels/conv_s8.py is the wrapper; build with:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -o libconv_s8.so conv_s8.cu). No --use_fast_math: the
// epilogue's int -> float conversion must round to nearest, and the
// scales of structurally dead operands (amax 1e-12: 1 / sx ~ 1.3e14,
// sx * sw ~ 1e-17) must not be flushed.
//
// uwt_conv_s8 replaces the XLA convolution that the JAX package's int8
//    tier runs for every calibrated conv (unet_watermark_tpu/ops/quant.py,
//    conv2d_maybe_quant: lax.conv_general_dilated(xq, wq, ...,
//    preferred_element_type=int32), then y = f32(acc) * (sx * sw[c]) cast
//    to the model dtype). It is not a TPU kernel: on the TPU, XLA lowers it
//    to the MXU.
//
//    What it computes: an implicit-GEMM convolution. x is int8 NHWC
//    [N][H][W][Cin], w int8 [Cout][Kpad] with row k = (ky * KW + kx) * Cin
//    + ci of the OIHW weight and zeros from K = KH * KW * Cin to Kpad (a
//    multiple of kBK), y is NHWC [N][Ho][Wo][Cout] in bf16 or fp32. GEMM
//    M = N * Ho * Wo, N = Cout, K. Output pixel (oy, ox), tap (ky, kx)
//    reads the input at iy_d = oy * stride - pad + ky (the same for x) of
//    the input dilated by `dil` (the lhs dilation of the fused up-conv:
//    dil 2, stride 1, pad 2, a 4x4 kernel): a position with iy_d % dil != 0
//    or outside the dilated input reads zero. The dilation is index math;
//    the zero-interleaved input is never written. The sums are exact int32;
//    the epilogue is y = bf16_rn(f32_rn(acc) * scale[c]) (fp32: no cast),
//    scale = f32(sx) * sw, one rounded multiply as in XLA.
//
//    Bound: per conv, the larger of 2 M N K operations at 1979 T int8 ops/s
//    and the bytes of the int8 input, int8 weight and bf16 output at 3.35
//    TB/s (8 x 512^2): the deep encoder convs are bound by operations
//    (layer4's 3x3 512 -> 512 at 16^2: 9.7 G ops, 4.9 us, against 5.4 MB,
//    1.6 us), the shallow ones and the thin decoder convs by bytes
//    (layer1's 3x3 64 -> 64 at 128^2: 9.7 G ops, 4.9 us, against 25 MB,
//    7.5 us). The dilated up-conv does 16 taps an output where 4 are
//    non-zero.
//
//    Design (simple and right first): a block of kThreads = 128 threads (4
//    warps, 2 x 2) makes a kBM x kBN = 64 x 64 output tile. K runs in steps
//    of kBK = 64 bytes: each thread loads two 16-byte pieces of the A tile
//    (the im2col rows, gathered on the fly; Cin % 16 == 0 keeps a piece in
//    one tap) and two of the B tile into registers, stores them into one of
//    two shared-memory buffers (rows padded to 80 bytes: the fragment loads
//    hit 32 distinct banks) while the tensor cores work on the other, with
//    one barrier a step. Each warp runs mma.sync m16n8k32 s8.s8.s32 on a
//    32 x 32 sub-tile (2 x 4 MMAs a 32-deep step). Cin % 16 != 0 (the 3-
//    channel stem) takes the byte-gather instantiation of the A load. Later
//    work (ROADMAP.md): wgmma with TMA-fed rings, the up-conv split into
//    its four 2x2 phases, the activation quantize fused into the A load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kRow = kBK + 16;  // bytes a shared-memory row
constexpr int kThreads = 128;

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  void* y;
  int n, h, w_in, cin, ho, wo, cout, kh, kw, stride, pad, dil, k, kpad;
};

// One output pixel's place: its image's base offset and its top-left
// corner in dilated input coordinates; valid = 0 beyond M.
struct Pixel {
  int64_t base;
  int iy0, ix0;
  int valid;
};

__device__ __forceinline__ Pixel pixel_of(const Conv& c, int m) {
  Pixel p;
  int hw = c.ho * c.wo;
  p.valid = m < c.n * hw;
  int img = p.valid ? m / hw : 0;
  int r = p.valid ? m - img * hw : 0;
  int oy = r / c.wo, ox = r - (r / c.wo) * c.wo;
  p.base = (int64_t)img * c.h * c.w_in * c.cin;
  p.iy0 = oy * c.stride - c.pad;
  p.ix0 = ox * c.stride - c.pad;
  return p;
}

// The input offset of tap element k for pixel p, or -1 where it reads zero.
__device__ __forceinline__ int64_t tap_offset(const Conv& c, const Pixel& p,
                                              int k) {
  if (!p.valid || k >= c.k) return -1;
  int tap = k / c.cin;
  int ci = k - tap * c.cin;
  int ky = tap / c.kw;
  int kx = tap - ky * c.kw;
  int iy = p.iy0 + ky, ix = p.ix0 + kx;
  if (c.dil == 2) {
    if ((iy | ix) & 1) return -1;
    iy >>= 1;
    ix >>= 1;
  }
  if (iy < 0 || ix < 0 || iy >= c.h || ix >= c.w_in) return -1;
  return p.base + ((int64_t)iy * c.w_in + ix) * c.cin + ci;
}

template <bool kVec>
__device__ __forceinline__ int4 load_a(const Conv& c, const Pixel& p, int k) {
  if constexpr (kVec) {
    int64_t off = tap_offset(c, p, k);
    return off < 0 ? make_int4(0, 0, 0, 0)
                   : __ldg(reinterpret_cast<const int4*>(c.x + off));
  } else {
    union {
      int4 v;
      int8_t b[16];
    } u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int64_t off = tap_offset(c, p, k + j);
      u.b[j] = off < 0 ? (int8_t)0 : c.x[off];
    }
    return u.v;
  }
}

__device__ __forceinline__ void mma_s8(int* acc, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two neighbouring channels of one pixel (the second where `both`): one
// 8- or 4-byte store where the pair is aligned, else one store each.
__device__ __forceinline__ void store_pair(float* y, int64_t off, float v0,
                                           float v1, bool both) {
  if (both && !(off & 1)) {
    *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
    return;
  }
  y[off] = v0;
  if (both) y[off + 1] = v1;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* y, int64_t off,
                                           float v0, float v1, bool both) {
  if (both && !(off & 1)) {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(v0);
    v.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(y + off) = v;
    return;
  }
  y[off] = __float2bfloat16_rn(v0);
  if (both) y[off + 1] = __float2bfloat16_rn(v1);
}

template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
    conv_s8_kernel(const Conv c) {
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][kBN * kRow];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // this thread's two A rows and two B rows, and its 16-byte column
  const int lrow = t >> 2, lk = (t & 3) * 16;
  const Pixel p0 = pixel_of(c, m0 + lrow), p1 = pixel_of(c, m0 + lrow + 32);
  const int co0 = n0 + lrow, co1 = n0 + lrow + 32;
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4* w0 = co0 < c.cout
      ? reinterpret_cast<const int4*>(c.w + (int64_t)co0 * c.kpad + lk)
      : nullptr;
  const int4* w1 = co1 < c.cout
      ? reinterpret_cast<const int4*>(c.w + (int64_t)co1 * c.kpad + lk)
      : nullptr;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  int4 ra0 = load_a<kVec>(c, p0, lk), ra1 = load_a<kVec>(c, p1, lk);
  int4 rb0 = w0 ? __ldg(w0) : zero, rb1 = w1 ? __ldg(w1) : zero;
  const int steps = c.kpad / kBK;
  *reinterpret_cast<int4*>(&sa[0][lrow * kRow + lk]) = ra0;
  *reinterpret_cast<int4*>(&sa[0][(lrow + 32) * kRow + lk]) = ra1;
  *reinterpret_cast<int4*>(&sb[0][lrow * kRow + lk]) = rb0;
  *reinterpret_cast<int4*>(&sb[0][(lrow + 32) * kRow + lk]) = rb1;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {  // the next step's operands, in flight during the MMAs
      const int k = (s + 1) * kBK + lk;
      ra0 = load_a<kVec>(c, p0, k);
      ra1 = load_a<kVec>(c, p1, k);
      rb0 = w0 ? __ldg(w0 + (s + 1) * (kBK / 16)) : zero;
      rb1 = w1 ? __ldg(w1 + (s + 1) * (kBK / 16)) : zero;
    }
    const int8_t* A = sa[cur];
    const int8_t* B = sb[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r = A + (wm + i * 16 + gid) * kRow + kk + tig * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* r = B + (wn + j * 8 + gid) * kRow + kk + tig * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(r);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (more) {
      const int nxt = cur ^ 1;
      *reinterpret_cast<int4*>(&sa[nxt][lrow * kRow + lk]) = ra0;
      *reinterpret_cast<int4*>(&sa[nxt][(lrow + 32) * kRow + lk]) = ra1;
      *reinterpret_cast<int4*>(&sb[nxt][lrow * kRow + lk]) = rb0;
      *reinterpret_cast<int4*>(&sb[nxt][(lrow + 32) * kRow + lk]) = rb1;
    }
    __syncthreads();
  }

  // epilogue: y = f32_rn(acc) * scale[c], rounded once to OutT
  OutT* y = static_cast<OutT*>(c.y);
  const int M = c.n * c.ho * c.wo;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + wn + j * 8 + tig * 2;
    if (co >= c.cout) continue;
    const bool both = co + 1 < c.cout;
    const float s0 = c.scale[co], s1 = both ? c.scale[co + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + gid + half * 8;
        if (m >= M) continue;
        const float v0 = __int2float_rn(acc[i][j][half * 2]) * s0;
        const float v1 = __int2float_rn(acc[i][j][half * 2 + 1]) * s1;
        store_pair(y, (int64_t)m * c.cout + co, v0, v1, both);
      }
    }
  }
}

template <typename OutT>
void launch(const Conv& c, bool vec, cudaStream_t stream) {
  const int M = c.n * c.ho * c.wo;
  dim3 grid((M + kBM - 1) / kBM, (c.cout + kBN - 1) / kBN);
  if (vec)
    conv_s8_kernel<true, OutT><<<grid, kThreads, 0, stream>>>(c);
  else
    conv_s8_kernel<false, OutT><<<grid, kThreads, 0, stream>>>(c);
}

}  // namespace

extern "C" {

// x: int8 NHWC, w: int8 [cout][kpad], scale: fp32 [cout], y: NHWC bf16
// (out_bf16 = 1) or fp32. Returns a cudaError_t code (0: launched).
int uwt_conv_s8(const int8_t* x, const int8_t* w, const float* scale,
                void* y, int n, int h, int w_in, int cin, int ho, int wo,
                int cout, int kh, int kw, int stride, int pad, int dil,
                int kpad, int out_bf16, void* stream) {
  const int k = kh * kw * cin;
  if (n < 1 || h < 1 || w_in < 1 || cin < 1 || ho < 1 || wo < 1 ||
      cout < 1 || kh < 1 || kw < 1 || stride < 1 || pad < 0 ||
      (dil != 1 && dil != 2) || kpad < k || kpad % kBK != 0 ||
      (int64_t)n * ho * wo > 0x7fffffff - kBM ||
      (int64_t)n * h * w_in * cin > ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  Conv c{x, w, scale, y, n, h, w_in, cin, ho, wo, cout, kh, kw, stride, pad,
         dil, k, kpad};
  const bool vec = cin % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(c, vec, s);
  else
    launch<float>(c, vec, s);
  return (int)cudaGetLastError();
}

const char* uwt_conv_s8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
