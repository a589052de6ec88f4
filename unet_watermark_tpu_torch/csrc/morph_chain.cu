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
//    Bound: operations. The chain does 664 max-taps per pixel (elements of
//    5/33/89/57 taps, 14 steps) against 8 bytes of traffic per pixel, so at
//    512^2 x 8 it is ~1.39 G single ops (~42 us at 33.5 T ops/s, the 67
//    TFLOP/s fp32 peak with each FMA counted as one) against 16.8 MB (~5 us
//    at 3.35 TB/s).
//
//    Design: the TPU kernel keeps a whole image plus a 64-px ring in VMEM
//    (1.6 MB at 512^2); a Hopper block has at most 227 KB of shared memory.
//    So each block owns a kTile x kTile output tile and loads it with a halo
//    of the chain's accumulated radius (48) into shared memory as uint8,
//    ping-ponged: 2 x 160^2 = 51.2 KB. All steps run in shared memory; after
//    a step only the window shrunk by the radii so far is valid, and only
//    that window is computed. Cells beyond the image hold the border value of
//    the step that reads them next, which reproduces the cv2 border rule
//    exactly, so the result is bit-identical to the whole-image chain at the
//    image borders too. The chain is a compile-time constant: each step is
//    its own instantiation with the element's radius, row spans and window
//    known to the compiler, so the tap loops unroll into shared-memory loads
//    and ORs/ANDs. The halo recomputation costs ~2.8x the ideal tap count at
//    kTile = 64; cutting that and the one-byte-per-tap loads (bit-packed
//    rows, span maxima shared between rows) is later work.
//
// K2 uwt_smooth_threshold replaces the TPU kernel gaussian_smooth_threshold
//    (same file, _build(size, "smooth")): threshold at 0.5, separable 3-tap
//    Gaussian (sigma 0.5) with zero beyond the image, threshold at 0.5.
//    Bound: bytes (8 B and ~10 flops a pixel). One thread a pixel; the nine
//    reads hit L1/L2. The blur runs in fp32 with every product and sum
//    rounded on its own (no FMA contraction), in the order of the TPU kernel
//    and of the plain PyTorch version, so the two agree bit for bit. On a
//    binary input the output equals the input: the centre weight
//    0.787^2 = 0.619 exceeds 0.5 and the eight others sum to 0.381.

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int chain_halo(int k = 0) {
  return k == kSteps ? 0 : step_radius(k) + chain_halo(k + 1);
}

constexpr int kHalo = chain_halo();  // 48
constexpr int kTile = 64;
constexpr int kW = kTile + 2 * kHalo;
constexpr int kThreads = 256;
constexpr int kSmemBytes = 2 * kW * kW;
static_assert(kHalo == 48, "the watermark chain's accumulated radius");

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

// Runs steps K.. of the chain on src (valid on the window [Lo, kW - Lo)^2)
// and returns the buffer that holds the last step's output.
template <int K, int Lo>
__device__ __forceinline__ uint8_t* run_chain(uint8_t* src, uint8_t* dst,
                                              int y0, int x0, int s) {
  if constexpr (K == kSteps) {
    return src;
  } else {
    constexpr int r = step_radius(K);
    constexpr bool erode = step_erodes(K);
    constexpr uint8_t next_border = K + 1 < kSteps && step_erodes(K + 1);
    constexpr int lo = Lo + r;
    constexpr int w = kW - 2 * lo;
    for (int i = threadIdx.x; i < w * w; i += kThreads) {
      const int y = lo + i / w, x = lo + i % w;
      uint32_t v = erode;
#pragma unroll
      for (int dy = -r; dy <= r; ++dy) {
        const uint8_t* row = src + (y + dy) * kW + x;
        const int hw = half_width(r, dy);
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
          if (dx >= -hw && dx <= hw) v = erode ? (v & row[dx]) : (v | row[dx]);
        }
      }
      const int gy = y0 + y, gx = x0 + x;
      const bool inside = gy >= 0 && gy < s && gx >= 0 && gx < s;
      dst[y * kW + x] = inside ? (uint8_t)v : next_border;
    }
    __syncthreads();
    return run_chain<K + 1, lo>(dst, src, y0, x0, s);
  }
}

__global__ void __launch_bounds__(kThreads)
morph_chain_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int s) {
  extern __shared__ uint8_t smem[];
  const size_t img = (size_t)blockIdx.z * s * s;
  const int y0 = blockIdx.y * kTile - kHalo;
  const int x0 = blockIdx.x * kTile - kHalo;

  constexpr uint8_t border0 = step_erodes(0);
  for (int i = threadIdx.x; i < kW * kW; i += kThreads) {
    const int gy = y0 + i / kW, gx = x0 + i % kW;
    const bool inside = gy >= 0 && gy < s && gx >= 0 && gx < s;
    smem[i] = inside ? (uint8_t)(in[img + (size_t)gy * s + gx] > 0.5f)
                     : border0;
  }
  __syncthreads();

  const uint8_t* res = run_chain<0, 0>(smem, smem + kW * kW, y0, x0, s);

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile, tx = i % kTile;
    const int gy = y0 + kHalo + ty, gx = x0 + kHalo + tx;
    if (gy < s && gx < s) {
      out[img + (size_t)gy * s + gx] =
          res[(kHalo + ty) * kW + kHalo + tx] ? 1.0f : 0.0f;
    }
  }
}

__device__ __forceinline__ float binarized(const float* img, int s, int y,
                                           int x) {
  return (y >= 0 && y < s && x >= 0 && x < s && img[(size_t)y * s + x] > 0.5f)
             ? 1.0f : 0.0f;
}

__device__ __forceinline__ float taps3(float g0, float g1, float g2, float a,
                                       float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, a), __fmul_rn(g1, b)),
                   __fmul_rn(g2, c));
}

__global__ void smooth_threshold_kernel(const float* __restrict__ in,
                                        float* __restrict__ out, int s,
                                        float g0, float g1, float g2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= s || y >= s) return;
  const float* img = in + (size_t)blockIdx.z * s * s;
  float col[3];
  for (int j = 0; j < 3; ++j) {
    const int xx = x + j - 1;
    col[j] = taps3(g0, g1, g2, binarized(img, s, y - 1, xx),
                   binarized(img, s, y, xx), binarized(img, s, y + 1, xx));
  }
  const float g = taps3(g0, g1, g2, col[0], col[1], col[2]);
  out[(size_t)blockIdx.z * s * s + (size_t)y * s + x] = g > 0.5f ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

int uwt_morph_chain(const float* in, float* out, int n, int s, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      morph_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (s + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, n);
  morph_chain_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      in, out, s);
  return (int)cudaGetLastError();
}

int uwt_smooth_threshold(const float* in, float* out, int n, int s, float g0,
                         float g1, float g2, void* stream) {
  dim3 block(32, 8);
  dim3 grid((s + 31) / 32, (s + 7) / 8, n);
  smooth_threshold_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      in, out, s, g0, g1, g2);
  return (int)cudaGetLastError();
}

const char* uwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
