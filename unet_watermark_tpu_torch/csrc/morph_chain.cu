// Hopper (sm_90a) kernels of the watermark mask stage, with a plain C
// interface for ctypes (ops/kernels/morph_chain.py is the wrapper; build
// with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -o libmorph_chain.so morph_chain.cu).
//
// K1 uwt_morph_chain replaces the TPU kernel morph_chain_watermark
//    (unet_watermark_tpu/ops/pallas/morph_chain.py, _make_chain_kernel built
//    by _build(size, "watermark_pre")): threshold at 0.5, then the watermark
//    chain open(3) -> close(7)x3 -> close(11)x2 -> dilate(9)x2 with cv2
//    elliptical elements and cv2 borders (0 beyond the image for dilate, 1
//    for erode), each output clipped to the image.
//
//    Bound: bytes. Each pixel is read once as a float and written once (8 B),
//    16.8 MB at 512^2 x 8 (5.0 us at 3.35 TB/s). The chain's 664 taps a
//    pixel are done 32 pixels to a word operation, ~43 M word operations at
//    that shape (~1.3 us at 33.5 T single ops/s).
//
//    Design: one bit a pixel. A row is W = ceil(S/32) words; bit l of word i
//    is pixel 32 i + l, as __ballot_sync packs a warp's 32 coalesced loads.
//    A block owns a band of kBand output rows of one image at the image's
//    full width, and holds it with the chain's accumulated radius (kHalo =
//    48 rows) above and below in two ping-ponged shared-memory buffers of
//    (kBand + 2 kHalo) x W words, so there is no horizontal halo. A step of
//    radius r makes the span of each half-width h <= r of each source row
//    by funnel shifts of the row's word and its neighbours (a neighbour
//    beyond the image is an all-border word), and ORs (ANDs for erode) the
//    2r+1 spans that cv2's ellipse selects. A thread makes kSeg output rows
//    of one word column, so each source row's spans are computed once for
//    the kSeg output rows that read them. Only the window still valid after
//    each step is computed; rows beyond the image and the bits beyond S of
//    the last word hold the border value of the step that reads them next,
//    which is cv2's border rule, so the result is the whole-image chain's
//    bit for bit. The chain is a compile-time constant (kChain): each step
//    is an instantiation with its radius and ellipse rows known to the
//    compiler. The halo rows are re-read from L2, not device memory.
//    kBand, kSeg, kThreads and kPackUnroll are the fastest of the variants
//    that tools/k1_sweep.py timed on an H100 at 512^2 x 8 (PERF.md).
//
// K2 uwt_smooth_threshold replaces the TPU kernel gaussian_smooth_threshold
//    (same file, _build(size, "smooth")): threshold at 0.5, separable 3-tap
//    Gaussian (sigma 0.5) with zero beyond the image, threshold at 0.5.
//    Bound: bytes (8 B and ~10 flops a pixel; 5.0 us at 512^2 x 8). One pass:
//    a thread makes 4 consecutive pixels of a row from one float4 load of
//    that row and of the rows above and below (the two side columns by
//    scalar loads that hit L1) and writes one float4; S % 4 != 0 or an
//    unaligned tensor takes the scalar instantiation. The blur runs in fp32
//    with every product and sum rounded on its own (no FMA contraction), in
//    the order of the TPU kernel and of the plain PyTorch version, so the
//    two agree bit for bit. Its output equals (x > 0.5) for every input:
//    the centre weight 0.787^2 = 0.619 exceeds 0.5 and the eight others sum
//    to 0.381 (tests/test_torch_morph.py proves it on all 512 patterns).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum Op { kDilate = 0, kErode = 1 };
struct Step {
  Op op;
  int radius;  // the element is cv2's ellipse of side 2 * radius + 1
};

// maskproc.optimize_watermark_mask's morphology, one entry per primitive
// application (cv2's iterations=n repeats the primitive n times).
constexpr Step kChain[] = {
    {kErode, 1},  {kDilate, 1},                            // open(3)
    {kDilate, 3}, {kDilate, 3}, {kDilate, 3},
    {kErode, 3},  {kErode, 3},  {kErode, 3},               // close(7) x3
    {kDilate, 5}, {kDilate, 5}, {kErode, 5}, {kErode, 5},  // close(11) x2
    {kDilate, 4}, {kDilate, 4},                            // dilate(9) x2
};
constexpr int kSteps = sizeof(kChain) / sizeof(kChain[0]);

// Element accessors usable in device code (scalar elements of a constexpr
// array, read in constant expressions).
__host__ __device__ constexpr int step_radius(int k) {
  return kChain[k].radius;
}
__host__ __device__ constexpr bool step_erodes(int k) {
  return kChain[k].op == kErode;
}
// The word of a row beyond the image, and the identity of the step's OR/AND.
__host__ __device__ constexpr uint32_t border_word(int k) {
  return k < kSteps && step_erodes(k) ? ~0u : 0u;
}
constexpr int chain_halo(int k = 0) {
  return k == kSteps ? 0 : step_radius(k) + chain_halo(k + 1);
}

constexpr int kHalo = chain_halo();  // 48
constexpr int kBand = 32;            // output rows a block owns
constexpr int kSeg = 8;              // output rows a thread makes per step
constexpr int kThreads = 1024;
constexpr int kRows = kBand + 2 * kHalo;
constexpr int kMaxSize = 4096;       // largest S; the wrapper's K1_MAX_SIZE
constexpr int kMaxSmemBytes = 2 * kRows * (kMaxSize / 32) * 4;
constexpr int kDefaultSmemBytes = 48 * 1024;
constexpr int kPackUnroll = 16;  // row loads a warp keeps in flight
constexpr int kMaxDevices = 64;
static_assert(kHalo == 48, "the watermark chain's accumulated radius");
static_assert(kSeg <= kBand, "every step's window holds at least kBand rows");
static_assert(kMaxSmemBytes <= 232448, "a block's shared memory on sm_90");

// Row dy of cv2.getStructuringElement(MORPH_ELLIPSE, (2r+1, 2r+1)) is the
// span |dx| <= round(sqrt(r^2 - dy^2)); in integers, the largest k with
// k(k-1) < r^2 - dy^2 (sqrt of an integer never ends in exactly .5).
__host__ __device__ constexpr int half_width(int r, int dy) {
  int k = 0;
  while ((k + 1) * k < r * r - dy * dy) ++k;
  return k;
}
static_assert(half_width(5, 0) == 5 && half_width(5, 3) == 4 &&
                  half_width(4, 2) == 3 && half_width(3, 2) == 2 &&
                  half_width(3, 3) == 0,
              "cv2's ellipse rows");

template <bool kErode>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return kErode ? (a & b) : (a | b);
}

// Step K of the chain: rows [lo, kRows - lo) of dst from src, whose rows
// [lo - r, kRows - lo + r) are valid. y0 is the image row of local row 0;
// tail marks the bits of the last word that lie beyond the image.
template <int K>
__device__ __forceinline__ void run_step(const uint32_t* __restrict__ src,
                                         uint32_t* __restrict__ dst,
                                         int words, int lo, int y0, int s,
                                         uint32_t tail) {
  constexpr int r = step_radius(K);
  constexpr bool erode = step_erodes(K);
  constexpr uint32_t border = border_word(K);
  constexpr uint32_t next = border_word(K + 1);
  const int hi = kRows - lo;
  const int items = (hi - lo + kSeg - 1) / kSeg * words;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int i = item % words;
    // the last segment ends at hi and may overlap the one before it
    const int first = min(lo + item / words * kSeg, hi - kSeg);
    uint32_t acc[kSeg];
#pragma unroll
    for (int t = 0; t < kSeg; ++t) acc[t] = border;
#pragma unroll
    for (int j = 0; j < kSeg + 2 * r; ++j) {
      const uint32_t* row = src + (first - r + j) * words;
      const uint32_t w = row[i];
      const uint32_t left = i > 0 ? row[i - 1] : border;
      const uint32_t right = i + 1 < words ? row[i + 1] : border;
      uint32_t span[r + 1];  // span[h]: pixels x-h..x+h combined
      span[0] = w;
#pragma unroll
      for (int h = 1; h <= r; ++h) {
        span[h] = combine<erode>(
            span[h - 1], combine<erode>(__funnelshift_l(left, w, h),
                                        __funnelshift_r(w, right, h)));
      }
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        const int dy = j - r - t;  // source row first-r+j = output row + dy
        if (dy >= -r && dy <= r) {
          acc[t] = combine<erode>(acc[t], span[half_width(r, dy)]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const int y = first + t, gy = y0 + y;
      uint32_t v = acc[t];
      if (gy < 0 || gy >= s) {
        v = next;
      } else if (i == words - 1) {
        v = next ? (v | tail) : (v & ~tail);
      }
      dst[y * words + i] = v;
    }
  }
  __syncthreads();
}

// Runs steps K.. of the chain (after step K-1, rows [Lo, kRows - Lo) of src
// are valid) and returns the buffer that holds the last step's output.
template <int K, int Lo>
__device__ __forceinline__ const uint32_t* run_chain(uint32_t* src,
                                                     uint32_t* dst, int words,
                                                     int y0, int s,
                                                     uint32_t tail) {
  if constexpr (K == kSteps) {
    return src;
  } else {
    constexpr int lo = Lo + step_radius(K);
    run_step<K>(src, dst, words, lo, y0, s, tail);
    return run_chain<K + 1, lo>(dst, src, words, y0, s, tail);
  }
}

// grid (n, ceil(s / kBand)); dynamic shared memory 2 * kRows * W words
__global__ void __launch_bounds__(kThreads)
morph_chain_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int s) {
  extern __shared__ uint32_t smem[];
  const int words = (s + 31) >> 5;
  uint32_t* buf = smem;
  const size_t img = (size_t)blockIdx.x * s * s;
  const int y0 = blockIdx.y * kBand - kHalo;
  const uint32_t tail = (s & 31) ? ~0u << (s & 31) : 0u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr bool border0 = step_erodes(0);

  // pack: a warp reads 32 consecutive floats of a row (128 B, coalesced) a
  // word, kPackUnroll words in flight before their ballots
  for (int y = warp; y < kRows; y += kWarps) {
    const int gy = y0 + y;
    const bool row_in = gy >= 0 && gy < s;
    const float* row = in + img + (size_t)(row_in ? gy : 0) * s;
    for (int i0 = 0; i0 < words; i0 += kPackUnroll) {
      bool bit[kPackUnroll];
#pragma unroll
      for (int u = 0; u < kPackUnroll; ++u) {
        const int gx = (i0 + u) * 32 + lane;
        bit[u] = row_in && gx < s ? row[gx] > 0.5f : border0;
      }
#pragma unroll
      for (int u = 0; u < kPackUnroll; ++u) {
        const uint32_t word = __ballot_sync(~0u, bit[u]);
        if (lane == 0 && i0 + u < words) buf[y * words + i0 + u] = word;
      }
    }
  }
  __syncthreads();

  const uint32_t* res =
      run_chain<0, 0>(buf, buf + kRows * words, words, y0, s, tail);

  // unpack: a warp writes 32 consecutive floats of a row a word
  for (int y = kHalo + warp; y < kHalo + kBand; y += kWarps) {
    const int gy = y0 + y;
    if (gy >= s) break;
    float* row = out + img + (size_t)gy * s;
    for (int i = 0; i < words; ++i) {
      const int gx = i * 32 + lane;
      if (gx < s) row[gx] = (res[y * words + i] >> lane) & 1u ? 1.0f : 0.0f;
    }
  }
}

// Lets morph_chain_kernel take kMaxSmemBytes of shared memory on the current
// device; the attribute is set once per device.
cudaError_t allow_max_smem() {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(morph_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float binarized(float v) {
  return v > 0.5f ? 1.0f : 0.0f;
}

__device__ __forceinline__ float taps3(float g0, float g1, float g2, float a,
                                       float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, a), __fmul_rn(g1, b)),
                   __fmul_rn(g2, c));
}

constexpr int kQuadsX = 32, kRowsY = 8;  // K2's block: 32 x 4 px by 8 rows

// grid (xblocks * yblocks * n); a thread makes pixels x..x+3 of row y
template <bool kVec>
__global__ void __launch_bounds__(kQuadsX * kRowsY)
smooth_threshold_kernel(const float* __restrict__ in, float* __restrict__ out,
                        int s, int xblocks, int yblocks, float g0, float g1,
                        float g2) {
  const int bx = blockIdx.x % xblocks, rest = blockIdx.x / xblocks;
  const int x = (bx * kQuadsX + threadIdx.x) * 4;
  const int y = rest % yblocks * kRowsY + threadIdx.y;
  if (x >= s || y >= s) return;
  const size_t img = (size_t)(rest / yblocks) * s * s;
  // b[r][c]: binarized pixel (y + r - 1, x + c - 1), 0 beyond the image
  float b[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int yy = y + r - 1;
    const bool row_in = yy >= 0 && yy < s;
    const float* row = in + img + (size_t)(row_in ? yy : y) * s;
    if constexpr (kVec) {
      const float4 v = row_in ? *reinterpret_cast<const float4*>(row + x)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      b[r][1] = binarized(v.x);
      b[r][2] = binarized(v.y);
      b[r][3] = binarized(v.z);
      b[r][4] = binarized(v.w);
      b[r][0] = row_in && x > 0 ? binarized(row[x - 1]) : 0.0f;
      b[r][5] = row_in && x + 4 < s ? binarized(row[x + 4]) : 0.0f;
    } else {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int xx = x + c - 1;
        b[r][c] = row_in && xx >= 0 && xx < s ? binarized(row[xx]) : 0.0f;
      }
    }
  }
  float col[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) col[c] = taps3(g0, g1, g2, b[0][c], b[1][c],
                                             b[2][c]);
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = taps3(g0, g1, g2, col[j], col[j + 1], col[j + 2]) > 0.5f ? 1.0f
                                                                    : 0.0f;
  }
  float* dst = out + img + (size_t)y * s + x;
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x + j < s) dst[j] = o[j];
    }
  }
}

}  // namespace

extern "C" {

int uwt_morph_chain(const float* in, float* out, int n, int s, void* stream) {
  if (n < 1 || s < 1 || s > kMaxSize) return (int)cudaErrorInvalidValue;
  const int smem = 2 * kRows * ((s + 31) / 32) * (int)sizeof(uint32_t);
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = allow_max_smem();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n, (s + kBand - 1) / kBand);
  morph_chain_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(in, out,
                                                                     s);
  return (int)cudaGetLastError();
}

int uwt_smooth_threshold(const float* in, float* out, int n, int s, float g0,
                         float g1, float g2, void* stream) {
  if (n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const int xblocks = ((s + 3) / 4 + kQuadsX - 1) / kQuadsX;
  const int yblocks = (s + kRowsY - 1) / kRowsY;
  const long long blocks = (long long)xblocks * yblocks * n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(kQuadsX, kRowsY);
  const bool vec = s % 4 == 0 && ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
  if (vec) {
    smooth_threshold_kernel<true><<<(unsigned)blocks, block, 0,
                                    (cudaStream_t)stream>>>(
        in, out, s, xblocks, yblocks, g0, g1, g2);
  } else {
    smooth_threshold_kernel<false><<<(unsigned)blocks, block, 0,
                                     (cudaStream_t)stream>>>(
        in, out, s, xblocks, yblocks, g0, g1, g2);
  }
  return (int)cudaGetLastError();
}

const char* uwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
