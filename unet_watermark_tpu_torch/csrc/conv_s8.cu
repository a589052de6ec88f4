// Hopper (sm_90a) kernels of the int8 inference tier, with a plain C
// interface for ctypes (ops/kernels/conv_s8.py is the wrapper; build with:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -o libconv_s8.so conv_s8.cu). No --use_fast_math: the
// epilogue's int -> float conversion and the quantize's multiply must round
// to nearest, and the scales of structurally dead operands (amax 1e-12:
// 1 / sx ~ 1.3e14, sx * sw ~ 1e-17) must not be flushed.
//
// Neither is a TPU kernel: on the TPU, XLA lowers both to the MXU and the
// VPU. They replace what the JAX package's int8 tier runs for every
// calibrated conv (unet_watermark_tpu/ops/quant.py, conv2d_maybe_quant).
//
// uwt_quantize_s8 replaces the activation quantize (quantize_activation:
//    xq = clip(round(x * f32(1 / sx)), ±127) as int8; in the port, five
//    torch passes). One pass: a thread reads pieces of 16 elements (bf16
//    or fp32, NHWC; two pieces, both loads in flight, where the tensor is
//    aligned and whole pieces) and writes their 16 int8 values with one
//    16-byte store each; the multiply is one rounded fp32 multiply, rintf
//    rounds half to even. The output may carry more channels than the
//    input, as zeros (the 3-channel stem's operand is written at 16
//    channels, so the conv reads it in 16-byte pieces). Bound: bytes (2 or
//    4 read + 1 written an element, at 3.35 TB/s).
//
// uwt_conv_s8 replaces the convolution (lax.conv_general_dilated(xq, wq,
//    ..., preferred_element_type=int32), then y = f32(acc) * (sx * sw[c])
//    cast to the model dtype).
//
//    What it computes: an implicit-GEMM convolution. x is int8 NHWC
//    [N][H][W][Cin] with Cin a multiple of 16, y NHWC [N][Ho][Wo][Cout] in
//    bf16 or fp32. GEMM M = output pixels, N = Cout, K = taps * Cin, row k =
//    tap * Cin + ci. The sums are exact int32 (any tiling or order gives
//    the same bits); the epilogue is y = bf16_rn(f32_rn(acc) * scale[c])
//    (fp32: no cast), scale = f32(sx) * sw, one rounded multiply as in XLA.
//    The lhs-dilated 4x4 up-conv (padding 2, dilation 2, output 2H x 2W)
//    runs as its four output phases: output (2p + a, 2q + b) reads only the
//    taps ky = a + 2 ty, kx = b + 2 tx (ty, tx in {0, 1}) at input (p - 1 +
//    a + ty, q - 1 + b + tx), so each phase is a 2x2 stride-1 conv of the
//    undilated x with 4 entries of the same int8 weight: K = 4 Cin, not
//    16 Cin, and no zero tap is read.
//
//    The weight is packed once (pack_weight in the wrapper) into the
//    kernel's shared-memory images of B: for the gather mode [phase][K /
//    128][Cout_pad][128] bytes; for the TMA modes [phase][chunks][kh][kw]
//    [Cout_pad][chunk] (each tap's channels in chunks of 32, 64 or 128
//    bytes as Cin <= 32, <= 64 or more); Cout_pad a multiple of the tile
//    width BN, rows in the swizzle of their width (16-byte piece j of row
//    r of b bytes stored at piece j ^ ((r b >> 7) % (b / 16))), zeros past
//    K, Cin and Cout.
//
//    Bound: per conv, the larger of 2 M N K operations (4 taps an up-conv
//    output) at 1979 T int8 ops/s and the bytes of the int8 input and
//    weight and the output at 3.35 TB/s. At 8 x 512^2 the deep encoder
//    convs are bound by operations, the shallow ones and the thin decoder
//    convs by bytes.
//
//    Design: a persistent grid (one block an SM slot, walking the tiles)
//    of blocks of one producer warpgroup and kWG = 1 or 2 consumer
//    warpgroups, each tile BM x BN (BM = 64 kWG; BN = 16, 32, 64 or 128
//    from Cout, so the Cout-16/32 decoder convs do not pad to 64). K runs
//    through a ring of kStages shared-memory stages, each guarded by a
//    "full" and an "empty" mbarrier; the ring runs on across a block's
//    tiles, so the producer fills the next tile's stages while the
//    consumers finish the last one. Each consumer warpgroup runs
//    wgmma.mma_async m64nBNk32.s32.s8.s8 (both operands K-major from
//    swizzled shared memory), keeps one step's wgmmas in flight, and
//    releases a stage when the wgmmas reading it have completed. Nothing
//    is staged through registers. Each consumer warp's 16 x BN outputs go
//    out through shared memory in 16-byte stores. BM = 64 where 128-row
//    tiles would number fewer than two an SM (the 16^2-64^2 encoder convs).
//
//    A comes in one of three ways (the wrapper's conv_mode):
//    - gather (stride-2 convs, the stem, rows that do not tile): a step is
//      128 bytes of K; the producer's 128 threads gather the im2col rows
//      in 16-byte cp.async pieces, zero-filling taps outside the image and
//      rows past M, and arrive on the full barrier when their pieces land;
//      thread 0 brings the B tile by bulk copy (the TMA engine).
//    - halo (3x3 stride-1 convs and the up-conv's 2x2 phases, where a tile
//      lies in one output row and BN <= 64): a step is one input row of a
//      channel chunk, BM + kw - 1 pixels in one TMA box (zero past the
//      image and past Cin), and the row's kw taps read it from pixel 0, 1,
//      2 (wgmma descriptors one row apart: the swizzle follows the read
//      address), each against its own B tile: an input byte is fetched 3
//      times, not 9 (4 phases of 2 taps: 2, not 4).
//    - taps (the same convs where a tile is whole output rows of one image;
//      preferred at BN = 128, whose halo steps would hold three 16 KB B
//      tiles): a step is one tap's chunk, a TMA box of BM / W rows of W
//      pixels.
//    In the TMA modes the producer's thread 0 alone issues a stage's copies.
//
//    What holds it back (conv_s8_sweep and a per-step trace, 8 x 512^2
//    UNet++, H100): the gather mode's producer cannot issue faster than
//    its cp.async pieces land (~0.8 us a 16 KB step: the SM's requests in
//    flight are few), and every mode waits ~1-1.5 us for a step's copies
//    under load, which a 3-deep ring hides only where a step's wgmmas are
//    long; deeper rings cost blocks an SM and lost. Not yet: the stem and
//    the stride-2 convs by TMA, cluster multicast of B, BN = 256.

#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBK = 128;       // bytes of K a stage: one 128-byte swizzled row
// the ring's depth (conv_s8_sweep: 3 beat 2, 4 and 6 in the gather mode;
// deeper rings for the TMA modes' short steps, at fewer blocks an SM, lost)
constexpr int kStages = 3;
constexpr int kProducers = 128;
constexpr long long kWaitLimitNs = 10000000000LL;  // see mbar_wait

struct Conv {
  CUtensorMap xmap;     // TMA modes: x as [N][H][W][cin], boxes of 1 x
                        // box_h x box_w x chunk, in chunk's swizzle
  const int8_t* x;      // int8 NHWC
  const int8_t* w;      // packed: [phases][kpad / kBK][cout_pad][kBK]
  const float* scale;   // fp32 [cout]
  void* y;              // NHWC, bf16 or fp32
  int n, h, w_in, cin;
  int mh, mw;           // a phase's output grid: M = n * mh * mw
  int ho, wo, cout, cout_pad;
  int kh, kw, stride, pad;  // a phase's taps; pad: the dense conv's
  int phases;           // 1, or 4 (the up-conv's output phases)
  int k, kpad;          // K = kh * kw * cin, rounded up to kBK (halo: a
                        // phase's chunks * kh * kw * chunk)
  int chunk, chunks;    // TMA modes: bytes of a channel chunk (32, 64 or
                        // 128: the row of its swizzle), and cin's chunks
  int tps;              // TMA modes: taps a step (halo: kw; taps: 1)
};

// Where phase z reads and writes: input row iy = oy * stride - pad_y + ky,
// output row oy * ys + ya (the same for columns), and its packed weight.
struct Phase {
  int pad_y, pad_x, ys, ya, xs, xa;
  const int8_t* w;
};

__device__ __forceinline__ Phase phase_of(const Conv& c, int z) {
  Phase p;
  if (c.phases == 4) {
    const int a = z >> 1, b = z & 1;
    p.pad_y = 1 - a;
    p.pad_x = 1 - b;
    p.ys = p.xs = 2;
    p.ya = a;
    p.xa = b;
  } else {
    p.pad_y = p.pad_x = c.pad;
    p.ys = p.xs = 1;
    p.ya = p.xa = 0;
  }
  p.w = c.w + (int64_t)z * c.kpad * c.cout_pad;
  return p;
}

// One A row of a tile: its image's base offset in x and its top-left tap's
// input position; base < 0 past M.
struct RowInfo {
  long long base;
  int iy0, ix0;
};

// ---- PTX wrappers ---------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Until the barrier's phase of this parity has completed (the loop stays
// inside the asm, so a warp leaves it together). A wait that has not ended
// after kWaitLimitNs (%globaltimer, read only once the first try fails)
// traps: a pipeline fault ends the launch with an error instead of hanging
// the card. 0: no limit.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if constexpr (kWaitLimitNs > 0)
    asm volatile(
        "{\n.reg .pred done;\n.reg .u64 t0, t1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@done bra DONE;\n"
        "mov.u64 t0, %%globaltimer;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@done bra DONE;\n"
        "mov.u64 t1, %%globaltimer;\n"
        "sub.u64 t1, t1, t0;\n"
        "setp.lt.u64 done, t1, %2;\n"
        "@done bra WAIT;\n"
        "trap;\n"
        "DONE:\n}\n" ::"r"(bar),
        "r"(parity), "l"(kWaitLimitNs)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// bytes of contiguous global memory into shared memory by the TMA engine;
// completes `bytes` of the barrier's transaction count
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a box of a 4-D tensor map into shared memory by the TMA engine (zeros
// where it leaves the tensor); completes its bytes of the barrier's count
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// 16 bytes, of which the first src_bytes (0 or 16) are read, the rest
// zero; through L2 only (caching the pieces in L1 as well made no
// difference: conv_s8_sweep)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one arrival on the barrier once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// The wgmma descriptor of a K-major tile in the swizzle of `row`-byte rows
// (128, 64 or 32): 8-row groups 8 rows apart (SBO); the leading offset is
// unused in these layouts. The swizzle is applied to the address each row
// is read at (16-byte piece j of the row at address a sits at piece j ^
// ((a >> 7) & (row / 16 - 1)), as TMA writes it), so a tile may start at
// any row of a buffer written that way with the base offset left 0 (held
// on the card: the halo mode's shifted taps). Adding 2 moves K by 32
// bytes.
__device__ __forceinline__ uint64_t sw_desc(uint32_t saddr, int row) {
  const uint64_t mode = row == 128 ? 1 : row == 64 ? 2 : 3;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * row) >> 4) << 32) | (mode << 62);
}


// D[64 x N] (s32, in registers) += A[64 x 32] * B[32 x N] (s8, shared)
template <int N>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b,
                                      int acc);

template <>
__device__ __forceinline__ void wgmma<16>(int* d, uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<32>(int* d, uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<64>(int* d, uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<128>(int* d, uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// fp32 or bf16 pairs of neighbouring channels of one pixel (the second
// where `both`): one 8- or 4-byte store where the pair is aligned
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

// A consumer warp's 16 output rows of BN channels are staged in shared
// memory, so that they leave in 16-byte stores: the row pitch, padded by 16
// bytes so that the 8 rows a fragment store writes fall in distinct banks.
template <int BN, typename OutT>
__host__ __device__ constexpr int out_pitch() {
  return BN * (int)sizeof(OutT) + 16;
}

// A stage's A tile: BM rows of `row` bytes (kBK, or a TMA mode's chunk),
// or in the halo mode BM + kw - 1 input pixels of one row (room for 8 more
// rows keeps the stages aligned to the swizzle's 8-row pattern); its B
// tile: the step's taps (1, or the halo mode's kw) of BN rows.
template <int kWG, bool kTma>
__host__ __device__ constexpr int a_stage_bytes(int row) {
  return (64 * kWG + (kTma ? 8 : 0)) * row;
}

template <int BN>
__host__ __device__ constexpr int b_stage_bytes(int row, int taps) {
  return taps * BN * row;
}

template <int BN, int kWG, bool kTma, typename OutT>
constexpr size_t conv_smem_bytes(int row, int taps) {
  // 1024 of slack to align the ring, the barriers, the tile's row table,
  // the consumer warps' output rows
  return (size_t)kStages * (a_stage_bytes<kWG, kTma>(row) +
                            b_stage_bytes<BN>(row, taps)) +
         1024 + 2 * kStages * sizeof(uint64_t) + 64 * kWG * sizeof(RowInfo) +
         (size_t)4 * kWG * 16 * out_pitch<BN, OutT>();
}

// blocks an SM the register budget is set for: two where the accumulator
// is small, one for the 128 x 128 tile
template <int BN, int kWG>
constexpr int conv_min_blocks() {
  return (BN == 128 && kWG == 2) ? 1 : 2;
}

// Tile t of a launch: output pixels m0 .. m0 + BM of phase z, channels n0 ..
// n0 + BN. Consecutive tiles are neighbouring pixel tiles of one channel
// tile and phase, so the blocks at work at one time share B and their A
// halos in L2.
struct Tile {
  int m0, n0, z;
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_of(const Conv& c, int t, int m_tiles) {
  const int n_tiles = c.cout_pad / BN;
  const int rest = t / m_tiles;
  return Tile{(t - rest * m_tiles) * BM, (rest % n_tiles) * BN,
              rest / n_tiles};
}

// A TMA mode's A box, in pixels: halo BM + kw - 1 of one row; taps BM
__device__ __forceinline__ int a_box_pixels(const Conv& c, int bm) {
  return c.tps > 1 ? bm + c.kw - 1 : bm;
}

template <int BN, int kWG, bool kTma, typename OutT>
__global__ void __launch_bounds__(128 * (kWG + 1), conv_min_blocks<BN, kWG>())
    conv_s8_kernel(const __grid_constant__ Conv c) {
  constexpr int BM = 64 * kWG;
  const int kRow = kTma ? c.chunk : kBK;
  const int kABytes = a_stage_bytes<kWG, kTma>(kRow);
  const int kBBytes = b_stage_bytes<BN>(kRow, kTma ? c.tps : 1);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;
  constexpr int S = kStages;
  uint8_t* sb = sa + S * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + S * kBBytes);
  uint64_t* empty = full + S;
  RowInfo* rows = reinterpret_cast<RowInfo*>(empty + S);
  uint8_t* out_rows = reinterpret_cast<uint8_t*>(rows + BM);

  const int tid = threadIdx.x;
  const int hw = c.mh * c.mw;
  const int M = c.n * hw;
  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * (c.cout_pad / BN) * c.phases;
  const int steps = kTma ? c.chunks * c.kh * (c.kw / c.tps) : c.kpad / kBK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // a TMA mode's stage is one TMA load and tps bulk copies, from the
      // producer's thread 0; otherwise each producer thread's cp.async
      // copies and thread 0's bulk copy
      mbar_init(smem_u32(&full[s]), kTma ? 1 : kProducers + 1);
      mbar_init(smem_u32(&empty[s]), 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ...; its ring runs on
  // across them (the stage and lap counters are the block's): the producer
  // fills the next tile's stages while the consumers finish the last
  // one's wgmmas and epilogue.
  if (tid >= 128 * kWG) {
    // ---- producer warpgroup ----------------------------------------------
    const int p = tid - 128 * kWG;
    if (kTma && p != 0) return;  // thread 0 issues a TMA mode's copies
    // thread p gathers 16-byte piece p % 8 of rows p / 8 + 16 i
    const int piece = p & 7;
    const uint32_t sa0 = smem_u32(sa), sb0 = smem_u32(sb);
    int s = 0, lap = 0;  // the ring's stage and its lap's parity
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile = tile_of<BM, BN>(c, t, m_tiles);
      const Phase ph = phase_of(c, tile.z);
      if constexpr (kTma) {
        // Step (chunk, ty, tx0) brings, by one TMA box (zero past the image
        // and past cin), a chunk of channels (C bytes, a row of C's
        // swizzle) of input pixels (oy0 + y - pad_y + ty, ox0 + x - pad_x
        // + tx0), y < box_h, x < box_w, and the B tiles of its tps taps;
        // tap tx0 + j reads the box from pixel j on. Halo: the tile is BM
        // pixels of one output row, box_w = BM + kw - 1, tps = kw. Taps:
        // the tile is BM / mw whole rows, box_w = mw, tps = 1.
        const int img = tile.m0 / hw, r0 = tile.m0 - img * hw;
        const int oy = r0 / c.mw, ix0 = r0 - oy * c.mw - ph.pad_x;
        const int C = c.chunk, across = c.kw / c.tps;
        const uint32_t bytes = (a_box_pixels(c, BM) + c.tps * BN) * C;
        for (int ks = 0; ks < steps; ++ks, s = s + 1 == S ? 0 : s + 1,
                 lap ^= s == 0) {
          const uint32_t bar = smem_u32(&full[s]);
          mbar_wait(smem_u32(&empty[s]), lap ^ 1);
          mbar_expect_tx(bar, bytes);
          const int row = ks / across;  // chunk * kh + ty
          const int tx0 = (ks - row * across) * c.tps;
          const int chunk = row / c.kh;
          tma_load_4d(sa0 + s * kABytes, &c.xmap, chunk * C, ix0 + tx0,
                      oy - ph.pad_y + (row - chunk * c.kh), img, bar);
          for (int j = 0; j < c.tps; ++j)
            bulk_g2s(sb0 + s * kBBytes + j * BN * C,
                     ph.w + ((int64_t)(row * c.kw + tx0 + j) * c.cout_pad +
                             tile.n0) * C,
                     BN * C, bar);
        }
        continue;
      }
      producers_sync();  // every producer is done with the last row table
      if (p < BM) {      // the tile's row table, one row a thread
        const int m = tile.m0 + p;
        RowInfo ri{-1, 0, 0};
        if (m < M) {
          const int img = m / hw, r = m - img * hw;
          const int oy = r / c.mw, ox = r - oy * c.mw;
          ri.base = (long long)img * c.h * c.w_in * c.cin;
          ri.iy0 = oy * c.stride - ph.pad_y;
          ri.ix0 = ox * c.stride - ph.pad_x;
        }
        rows[p] = ri;
      }
      producers_sync();
      for (int ks = 0; ks < steps; ++ks, s = s + 1 == S ? 0 : s + 1,
               lap ^= s == 0) {
        mbar_wait(smem_u32(&empty[s]), lap ^ 1);
        if (p == 0) {
          mbar_expect_tx(smem_u32(&full[s]), kBBytes);
          bulk_g2s(sb0 + s * kBBytes,
                   ph.w + ((int64_t)ks * c.cout_pad + tile.n0) * kBK,
                   kBBytes, smem_u32(&full[s]));
        }
        const int k = ks * kBK + piece * 16;
        const bool kin = k < c.k;
        int ky = 0, kx = 0, ci = 0;
        if (kin) {  // a 16-byte piece lies in one tap (Cin % 16 == 0)
          const int tap = k / c.cin;
          ci = k - tap * c.cin;
          ky = tap / c.kw;
          kx = tap - ky * c.kw;
        }
        const uint32_t stage = sa0 + s * kABytes;
#pragma unroll
        for (int i = 0; i < BM / 16; ++i) {
          const int r = (p >> 3) + 16 * i;
          const RowInfo ri = rows[r];
          const int iy = ri.iy0 + ky, ix = ri.ix0 + kx;
          const bool in = kin && ri.base >= 0 &&
                          (unsigned)iy < (unsigned)c.h &&
                          (unsigned)ix < (unsigned)c.w_in;
          const int8_t* src =
              in ? c.x + ri.base + ((int64_t)iy * c.w_in + ix) * c.cin + ci
                 : c.x;
          cp_async_16(stage + r * kBK + ((piece ^ (r & 7)) << 4), src,
                      in ? 16 : 0);
        }
        cp_async_arrive(smem_u32(&full[s]));
      }
    }
    cp_async_wait_all();
  } else {
    // ---- consumer warpgroups -----------------------------------------------
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    // this warpgroup's first A row (TMA modes: rows of c.chunk bytes)
    const uint32_t a0 = smem_u32(sa) + wg * 64 * (kTma ? c.chunk : kBK);
    const uint32_t b0 = smem_u32(sb);
    OutT* y = static_cast<OutT*>(c.y);
    int s = 0, lap = 0, last = 0;  // last: the previous step's stage
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile = tile_of<BM, BN>(c, t, m_tiles);
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int ks = 0; ks < steps; ++ks, last = s, s = s + 1 == S ? 0 : s + 1,
               lap ^= s == 0) {
        mbar_wait(smem_u32(&full[s]), lap);
        // the gather mode's cp.async writes, before the wgmmas' reads
        if constexpr (!kTma) fence_proxy_async();
        wgmma_fence();
        if constexpr (kTma) {
          const int C = c.chunk;
          for (int j = 0; j < c.tps; ++j) {  // tap j: the box from pixel j
            const uint64_t da = sw_desc(a0 + s * kABytes + j * C, C);
            const uint64_t db = sw_desc(b0 + s * kBBytes + j * BN * C, C);
            for (int kk = 0; kk < C / 32; ++kk)
              wgmma<BN>(acc, da + 2 * kk, db + 2 * kk, 1);
          }
        } else {
          const uint64_t da = sw_desc(a0 + s * kABytes, kBK);
          const uint64_t db = sw_desc(b0 + s * kBBytes, kBK);
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk)
            wgmma<BN>(acc, da + 2 * kk, db + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's wgmmas are done: free it
        if (ks > 0 && lane == 0) mbar_arrive(smem_u32(&empty[last]));
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(smem_u32(&empty[last]));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        asm volatile("" : "+r"(acc[i])::"memory");

      // epilogue: y = f32_rn(acc) * scale[c], rounded once to OutT. Thread
      // (warp, lane) holds rows 16 warp + lane / 4 (+ 8) of its
      // warpgroup's 64, columns 8 j + 2 (lane % 4) (+ 1): acc[4 j + 2 half
      // + col]
      const Phase ph = phase_of(c, tile.z);
      constexpr int kE = sizeof(OutT), kPer = 16 / kE;
      constexpr int kP = out_pitch<BN, OutT>();
      if (c.cout % kPer == 0) {
        // through the warp's rows in shared memory, 16 bytes a store
        uint8_t* st = out_rows + (wg * 4 + warp) * 16 * kP;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = j * 8 + (lane & 3) * 2, co = tile.n0 + col;
            const bool in = co < c.cout;
            const float v0 =
                in ? __fmul_rn(__int2float_rn(acc[4 * j + 2 * half]),
                               c.scale[co])
                   : 0.0f;
            const float v1 =
                in ? __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]),
                               c.scale[co + 1])
                   : 0.0f;
            store_pair(reinterpret_cast<OutT*>(
                           st + ((lane >> 2) + 8 * half) * kP),
                       col, v0, v1, true);
          }
        }
        long long pix_r = -1;  // row `lane`'s output pixel (lanes 0-15)
        const int m_r = tile.m0 + wg * 64 + warp * 16 + lane;
        if (lane < 16 && m_r < M) {
          const int img = m_r / hw, r = m_r - img * hw;
          const int oy = r / c.mw, ox = r - oy * c.mw;
          pix_r = ((long long)img * c.ho + oy * ph.ys + ph.ya) * c.wo +
                  ox * ph.xs + ph.xa;
        }
        __syncwarp();
        const int chunks = (c.cout - tile.n0 < BN ? c.cout - tile.n0 : BN) /
                           kPer;
        uint8_t* yb = reinterpret_cast<uint8_t*>(y);
#pragma unroll
        for (int q = lane; q < 16 * (BN / kPer); q += 32) {
          const int row = q / (BN / kPer), ck = q - row * (BN / kPer);
          const long long pix = __shfl_sync(0xffffffffu, pix_r, row);
          if (pix >= 0 && ck < chunks)
            *reinterpret_cast<int4*>(
                yb + (pix * c.cout + tile.n0) * kE + ck * 16) =
                *reinterpret_cast<const int4*>(st + row * kP + ck * 16);
        }
        __syncwarp();
        continue;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = tile.m0 + wg * 64 + warp * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
        const int img = m / hw, r = m - img * hw;
        const int oy = r / c.mw, ox = r - oy * c.mw;
        const int64_t pix =
            ((int64_t)img * c.ho + oy * ph.ys + ph.ya) * c.wo + ox * ph.xs +
            ph.xa;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = tile.n0 + j * 8 + (lane & 3) * 2;
          if (co >= c.cout) continue;
          const bool both = co + 1 < c.cout;
          const float v0 =
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * half]), c.scale[co]);
          const float v1 =
              both ? __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]),
                               c.scale[co + 1])
                   : 0.0f;
          store_pair(y, pix * c.cout + co, v0, v1, both);
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// cuTensorMapEncodeTiled, looked up through the runtime (no link to
// libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A TMA mode's map of x: [N][H][W][cin] int8, boxes of `rows` rows of
// `pixels` pixels by `chunk` channels, in the swizzle of chunk-byte rows,
// zeros out of bounds.
cudaError_t encode_x_map(Conv& c, int pixels, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)c.cin, (cuuint64_t)c.w_in,
                              (cuuint64_t)c.h, (cuuint64_t)c.n};
  const cuuint64_t strides[3] = {(cuuint64_t)c.cin,
                                 (cuuint64_t)c.w_in * c.cin,
                                 (cuuint64_t)c.h * c.w_in * c.cin};
  const cuuint32_t box[4] = {(cuuint32_t)c.chunk, (cuuint32_t)pixels,
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      c.chunk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : c.chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(&c.xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<int8_t*>(c.x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// One block an SM slot (the occupancy the kernel's registers and its
// shared memory for this row width allow), each walking its share of the
// tiles. The slots of an instantiation and row width on a device are found
// at their first launch there, and its shared-memory limit raised.
template <int BN, int kWG, bool kTma, typename OutT>
cudaError_t launch_conv(const Conv& c, cudaStream_t stream) {
  constexpr int BM = 64 * kWG;
  constexpr int kThreads = 128 * (kWG + 1);
  const int row = kTma ? c.chunk : kBK, taps = kTma ? c.tps : 1;
  // the slots differ by the shared memory: by row width and taps a step
  const int ri = (row == 32 ? 0 : row == 64 ? 1 : 2) * 4 + taps;
  const size_t smem = conv_smem_bytes<BN, kWG, kTma, OutT>(row, taps);
  static std::atomic<int> slots_on[kMaxDevices][12], limit_on[kMaxDevices];
  auto kernel = conv_s8_kernel<BN, kWG, kTma, OutT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || limit_on[dev].load() < (int)smem) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) limit_on[dev].store((int)smem);
  }
  int slots = dev < kMaxDevices ? slots_on[dev][ri].load() : 0;
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
    if (dev < kMaxDevices) slots_on[dev][ri].store(slots);
  }
  const int M = c.n * c.mh * c.mw;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * (c.cout_pad / BN) * c.phases;
  kernel<<<(int)(tiles < slots ? tiles : slots), kThreads, smem, stream>>>(c);
  return cudaGetLastError();
}

template <int BN, typename OutT>
cudaError_t dispatch_tile(const Conv& c, bool two, bool tma,
                          cudaStream_t s) {
  if (tma) {  // BN = 128 takes 64-row tiles only (shared memory)
    if constexpr (BN == 128) return launch_conv<BN, 1, true, OutT>(c, s);
    return two ? launch_conv<BN, 2, true, OutT>(c, s)
               : launch_conv<BN, 1, true, OutT>(c, s);
  }
  return two ? launch_conv<BN, 2, false, OutT>(c, s)
             : launch_conv<BN, 1, false, OutT>(c, s);
}

template <typename OutT>
cudaError_t dispatch_conv(const Conv& c, int bn, int bm, bool tma,
                          cudaStream_t s) {
  const bool two = bm == 128;
  switch (bn) {
    case 16:
      return dispatch_tile<16, OutT>(c, two, tma, s);
    case 32:
      return dispatch_tile<32, OutT>(c, two, tma, s);
    case 64:
      return dispatch_tile<64, OutT>(c, two, tma, s);
    default:
      return dispatch_tile<128, OutT>(c, two, tma, s);
  }
}

// ---- the activation quantize ------------------------------------------------
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(rint(v * inv), ±127) as the low byte of an int
__device__ __forceinline__ uint32_t q8(float v, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  return (uint32_t)__float2int_rn(r) & 0xFFu;
}

// 16 consecutive elements from a 16-byte aligned address
__device__ __forceinline__ void load16(const float* x, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(x) + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* x, float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int4 u = __ldg(reinterpret_cast<const int4*>(x) + i);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(b[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

constexpr int kQuantizeThreads = 256;

__device__ __forceinline__ int4 q16(const float* v, float inv) {
  uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) word[j >> 2] |= q8(v[j], inv) << (8 * (j & 3));
  return make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
}

// The 16 output bytes from o of y[pixel][0 .. cpad) = q8(x[pixel][0 ..
// c)), zeros from c to cpad: with cpad == c, 16 consecutive elements
// (vector loads where `vec`: x 16-byte aligned); with cpad > c (a multiple
// of 16), 16 channels of one pixel.
template <typename InT>
__device__ __forceinline__ void quantize_piece(const InT* __restrict__ x,
                                               int8_t* __restrict__ y,
                                               int64_t o, int64_t total, int c,
                                               int cpad, float inv, bool vec) {
  uint32_t word[4] = {0, 0, 0, 0};
  if (cpad == c && vec && o + 16 <= total) {
    float v[16];
    load16(x + o, v);
    *reinterpret_cast<int4*>(y + o) = q16(v, inv);
    return;
  }
  if (cpad == c) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (o + j < total)
        word[j >> 2] |= q8(to_f32(x[o + j]), inv) << (8 * (j & 3));
  } else {
    const int64_t px = o / cpad;
    const int ch0 = (int)(o - px * cpad);
    const InT* xp = x + px * c;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (ch0 + j < c)
        word[j >> 2] |= q8(to_f32(xp[ch0 + j]), inv) << (8 * (j & 3));
  }
  if (o + 16 <= total) {
    *reinterpret_cast<int4*>(y + o) =
        make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
  } else {
    for (int j = 0; o + j < total; ++j)
      y[o + j] = (int8_t)((word[j >> 2] >> (8 * (j & 3))) & 0xFFu);
  }
}

// Each thread makes two pieces of 16 output bytes (quantize_piece),
// kQuantizeThreads apart so that a warp's loads and stores stay
// contiguous. Where the tensor is whole aligned pieces with no padding,
// both pieces' loads are in flight before either is converted. Over a
// UNet++ forward's quantizes on an H100 (tools/conv_s8_sweep.py
// --quantize), two pieces a thread took 17 % less device time than one,
// and the loads in flight 3 % less again.
template <typename InT>
__global__ void __launch_bounds__(kQuantizeThreads)
    quantize_s8_kernel(const InT* __restrict__ x, int8_t* __restrict__ y,
                       int64_t pixels, int c, int cpad, float inv, bool vec) {
  const int64_t total = pixels * cpad;
  const int64_t pieces = (total + 15) / 16;
  const int64_t i = blockIdx.x * (int64_t)(2 * kQuantizeThreads) +
                    threadIdx.x;
  const int64_t k = i + kQuantizeThreads;
  if (cpad == c && vec && total % 16 == 0) {
    float a[16], b[16];
    if (i < pieces) load16(x + i * 16, a);
    if (k < pieces) load16(x + k * 16, b);
    if (i < pieces) *reinterpret_cast<int4*>(y + i * 16) = q16(a, inv);
    if (k < pieces) *reinterpret_cast<int4*>(y + k * 16) = q16(b, inv);
    return;
  }
  if (i < pieces) quantize_piece(x, y, i * 16, total, c, cpad, inv, vec);
  if (k < pieces) quantize_piece(x, y, k * 16, total, c, cpad, inv, vec);
}

}  // namespace

extern "C" {

// x: int8 NHWC with cin % 16 == 0, 16-byte aligned; w: the packed weight
// ([phases][kpad / 128][cout_pad][128] for mode 0, [phases][chunks][kh]
// [kw][cout_pad][chunk] of a phase's taps for modes 1 and 2, chunk 32, 64
// or 128 bytes as cin <= 32, <= 64 or more, rows in chunk's swizzle);
// scale: fp32 [cout]; y: NHWC bf16 (out_bf16 = 1) or fp32. dil 2 is the
// up-conv (kh = kw = 4, stride 1, pad 2, ho = 2h, wo = 2w), run as its
// four phases; bn in {16, 32, 64, 128} divides cout_pad; bm 64 or 128.
// mode 0 gathers A with cp.async; the TMA modes (the 3x3 stride-1 pad-1
// conv or the up-conv's phases; bm 64 where bn is 128) load it by TMA
// boxes: 1 (halo), bm dividing the output row, one box a row for the
// row's taps; 2 (taps), the output row dividing bm and each image's rows,
// one box a tap. Returns a cudaError_t code (0: launched).
int uwt_conv_s8(const int8_t* x, const int8_t* w, const float* scale,
                void* y, int n, int h, int w_in, int cin, int ho, int wo,
                int cout, int kh, int kw, int stride, int pad, int dil,
                int cout_pad, int bn, int bm, int mode, int out_bf16,
                void* stream) {
  if (n < 1 || h < 1 || w_in < 1 || cin < 16 || cin % 16 || cout < 1 ||
      kh < 1 || kw < 1 || stride < 1 || pad < 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      (bn != 16 && bn != 32 && bn != 64 && bn != 128) ||
      (bm != 64 && bm != 128) || cout_pad < cout || cout_pad % bn ||
      (int64_t)n * h * w_in * cin > ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  Conv c{{}, x, w, scale, y, n, h, w_in, cin, 0, 0, ho, wo, cout, cout_pad,
         kh, kw, stride, pad, 1, 0, 0, 0, 0, 1};
  if (dil == 2) {
    if (kh != 4 || kw != 4 || stride != 1 || pad != 2 || ho != 2 * h ||
        wo != 2 * w_in)
      return (int)cudaErrorInvalidValue;
    c.mh = h;
    c.mw = w_in;
    c.kh = c.kw = 2;
    c.phases = 4;
  } else if (dil == 1) {
    if (ho != (h + 2 * pad - kh) / stride + 1 ||
        wo != (w_in + 2 * pad - kw) / stride + 1 || ho < 1 || wo < 1)
      return (int)cudaErrorInvalidValue;
    c.mh = ho;
    c.mw = wo;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t m = (int64_t)n * c.mh * c.mw;
  if (m > 0x7fffffff - 128 || (int64_t)c.kh * c.kw * cin > 0x7fffffff - kBK ||
      (m + 63) / 64 * (cout_pad / 16) * c.phases > 0x7fffffff - (1 << 20))
    return (int)cudaErrorInvalidValue;
  c.k = c.kh * c.kw * cin;
  c.kpad = (c.k + kBK - 1) / kBK * kBK;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (mode) {  // stride-1 taps, tiles of whole rows or within one row
    const bool halo = mode == 1;
    if ((bn == 128 && bm != 64) ||
        (dil == 1 && (kh != 3 || kw != 3 || stride != 1 || pad != 1)) ||
        (halo ? c.mw % bm : bm % c.mw || c.mh % (bm / c.mw)))
      return (int)cudaErrorInvalidValue;
    c.chunk = cin <= 32 ? 32 : cin <= 64 ? 64 : kBK;
    c.chunks = (cin + c.chunk - 1) / c.chunk;
    c.kpad = c.chunks * c.kh * c.kw * c.chunk;
    c.tps = halo ? c.kw : 1;
    const cudaError_t e = halo ? encode_x_map(c, bm + c.kw - 1, 1)
                               : encode_x_map(c, c.mw, bm / c.mw);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16 ? dispatch_conv<__nv_bfloat16>(c, bn, bm, mode, s)
                        : dispatch_conv<float>(c, bn, bm, mode, s));
}

// x: bf16 (in_bf16 = 1) or fp32, `pixels` rows of c channels (NHWC); y:
// int8, pixels rows of cpad channels (cpad == c, or a multiple of 16 above
// c: zeros past c). inv: float32(1 / sx). Returns a cudaError_t code.
int uwt_quantize_s8(const void* x, int8_t* y, long long pixels, int c,
                    int cpad, float inv, int in_bf16, void* stream) {
  if (pixels < 0 || c < 1 || cpad < c || (cpad != c && cpad % 16) ||
      (reinterpret_cast<uintptr_t>(y) & 15) ||
      pixels > ((int64_t)1 << 40) / cpad)
    return (int)cudaErrorInvalidValue;
  const int64_t pieces = (pixels * cpad + 15) / 16;
  if (pieces == 0) return (int)cudaSuccess;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int blocks = (int)((pieces + 2 * kQuantizeThreads - 1) /
                           (2 * kQuantizeThreads));  // < 2^27
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    quantize_s8_kernel<__nv_bfloat16><<<blocks, kQuantizeThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), y, pixels, c, cpad, inv, vec);
  else
    quantize_s8_kernel<float><<<blocks, kQuantizeThreads, 0, s>>>(
        static_cast<const float*>(x), y, pixels, c, cpad, inv, vec);
  return (int)cudaGetLastError();
}

const char* uwt_conv_s8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
