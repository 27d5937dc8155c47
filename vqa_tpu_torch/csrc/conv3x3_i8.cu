// Kernel B: NHWC int8 conv3x3 (pad 1, stride 1) with int32 accumulation and a
// fused epilogue: optional 2x2 maxpool, dequant + bias + ReLU, then either a
// float store or an int8 requant for the next stage.
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/conv_hpack.py:_kernel (pooled
// conv on the H-pair-packed input; conv1 in the calibration pass) and also
// serves the int8 convs the JAX package leaves to XLA: the static-path conv1
// (vqa_tpu/ops/conv_stem.py:_conv1_xla_phases) and conv2-7
// (vqa_tpu/models/vgg.py int8 branch). PyTorch has no CUDA int8 x int8 ->
// int32 convolution with this epilogue.
//
// What bounds it on the H100: int8 operations. Every conv here does 576 to
// 4608 MACs per output, well above the ridge. The design is an implicit GEMM
// on Hopper's warpgroup MMA, wgmma.mma_async.m64n128k32.s32.s8.s8:
//   * a block is 4 warpgroups; each owns an 8 x 8 tile of conv outputs
//     (M = 64), the block 8 x 32 outputs x 128 output channels (N); K = 9
//     taps x C_in, one wgmma per tap and 32-channel chunk;
//   * A and B both come from shared memory through matrix descriptors in the
//     canonical K-major layout without swizzle (8-row x 16-byte core matrices
//     of 128 contiguous bytes). The input halo (10 x 34 pixels x 32 channels)
//     is stored as two 16-byte K halves of [10][34] pixels. M row 8r + px of
//     tap (ky, kx) is halo pixel (r + ky, 8 wg + px + kx), so a tap's A
//     operand is the same halo from another start address: core matrix r is
//     8 consecutive pixels of one halo row (stride SBO = one halo row, LBO =
//     one K half). A shifted window needs no ldmatrix and no A registers;
//   * the wrapper tiles the weights (ops/conv_hpack.pack_conv3x3_weights) so
//     that one block's chunk, [9 taps][128 channels][32 bytes] in core-matrix
//     order, is 36,864 contiguous bytes: one thread fetches it with a single
//     cp.async.bulk that completes on an mbarrier. The halo comes by cp.async
//     16-byte copies, whose zero fill is the conv's padding. With the weights
//     fetched by 16-byte cp.async too (2,304 per block and chunk), the loads
//     and not the MMAs set the kernel's time (PERF.md §6);
//   * a 4-stage ring: chunk ch + 2 loads while chunk ch multiplies, with one
//     barrier per chunk; 191 KB of shared memory, one block of 16 warps per
//     SM. The 2x2 pool needs no exchange along rows: M rows 16w + g and
//     16w + g + 8 of warp w are tile rows 2w and 2w + 1 at column g, so the
//     two rows of a window meet in one thread and its two columns in lanes 4
//     apart (one __shfl_xor_sync);
//   * the outputs are staged in shared memory and written with 16-byte
//     coalesced stores. No split-K, no atomics: deterministic.
// An earlier version of this kernel on mma.sync.m16n8k32 with ldmatrix ran
// ~1.7x slower at b32 (PERF.md §6): each warp read its own B fragments from
// shared memory, where a warpgroup's wgmma reads them once.
//   * C_in must be a multiple of 32 and C_out of 64 (VGG: 64..512); a
//     block's channels past C_out have zero weights and are not stored.
//
// Epilogue, bit-for-bit the plain PyTorch version in ops/conv_hpack.py:
//   acc = POOL ? max over the 2x2 quad (int32, exact: every later step is
//         non-decreasing because scale > 0) : acc
//   y   = relu(__fadd_rn(__fmul_rn(float(acc), scale[o]), bias[o]))
//   MODE 0: f32, MODE 1: bf16 (round to nearest even),
//   MODE 2: int8 clip(rint(__fdiv_rn(y, s_next[o])), -127, 127), computed
//   through a reciprocal where that provably gives the same integer
//   (needs_division below).
// Int32 sums are exact in any order (|acc| <= 4608 * 127^2 < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WGS = 4;                             // warpgroups per block
constexpr int STAGES = 4;                          // ring depth (chunks)
constexpr int TH = 8, TW = 8 * WGS;                // conv-output tile (pre-pool)
constexpr int BN = 128;                            // output channels per block
constexpr int CK = 32;                             // input channels per chunk
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int THREADS = 128 * WGS;
constexpr int HALF_BYTES = HALO_H * HALO_W * 16;   // one 16-byte K half of the halo
constexpr int HALO_BYTES = 2 * HALF_BYTES;         // 10,880
constexpr int TAP_BYTES = BN * CK;                 // 4,096
constexpr int W_BYTES = 9 * TAP_BYTES;             // 36,864
constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
constexpr int STAGING_BYTES = TH * TW * (BN * 4 + 16);   // f32 outputs, unpooled
constexpr int SMEM_BYTES =                                // 190,976
    STAGES * STAGE_BYTES > STAGING_BYTES ? STAGES * STAGE_BYTES : STAGING_BYTES;
static_assert(STAGE_BYTES % 16 == 0, "stages must stay 16-byte aligned");

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// One bulk copy of `bytes` into shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Waits for the phase of `bar` with this parity. If it never completes, the
// kernel traps instead of hanging: the trap aborts the process's CUDA context,
// reported at the next synchronization, and every later CUDA call of the
// process fails.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1ll << 22)) __trap();
  }
}

// Shared-memory matrix descriptor, canonical K-major layout without swizzle:
// `lbo` bytes to the next 16 bytes of K, `sbo` bytes to the next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d += A (64 x 32 s8) x B (32 x 128 s8), both from shared memory, issued
// asynchronously by the warpgroup.
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving other accesses of the accumulators across
// the wgmma fences and waits (the asm above does not say when they land).
__device__ __forceinline__ void pin(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float epi(int a, float s, float b) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(a), s), b);
  return v > 0.f ? v : 0.f;
}

__device__ __forceinline__ int clip_rint(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// clip(rint(__fdiv_rn(y, s)), -127, 127) without the IEEE division where
// that is provably the same: q = y * inv, inv = rn(1/s), is within t * 2^-22
// of the correctly rounded quotient rn(t), t = y / s (two roundings of 2^-24
// each, plus rn(t)'s own). So q >= 128.5 means rn(t) > 128 (127 after the
// clip), and for q < 128.5 the two lie within 129 * 2^-22 < 2^-14 of each
// other: if q is farther than 2^-14 from every half-integer, i.e.
// |q - rint(q)| < 0.5 - 2^-14 (q - rint(q) is exact), no rounding boundary
// of rint lies between them and rint(q) == rint(rn(t)). Otherwise (about
// 0.01% of outputs, or inv = NaN: s outside [2^-120, 2^120]) the division
// decides. Dividing every output instead made conv1-7 at batch 32 0.66 ms
// (29%) slower on an H100 (PERF.md §6).
__device__ __forceinline__ bool needs_division(float q) {
  return !(q >= 128.5f) && !(fabsf(__fsub_rn(q, rintf(q))) < 0.5f - 0x1p-14f);
}

__device__ __forceinline__ float reciprocal_or_nan(float s) {
  return (s >= 0x1p-120f && s <= 0x1p120f) ? __frcp_rn(s) : __int_as_float(0x7fc00000);
}

// NV pixels x two consecutive channels (o, o + 1) into their staging rows
// dst[v]; a[2v + e] is pixel v, channel o + e; inv: rn(1 / s_next) of the two
// channels (MODE 2). Called by whole warps: in MODE 2 the warp divides only
// when one of its lanes needs it, so the division is skipped, not predicated.
template <int MODE, int NV>
__device__ __forceinline__ void stage(unsigned char* const* dst, const int* a, int o,
                                      const float* scale, const float* bias,
                                      const float* s_next, const float* inv) {
  const float s[2] = {__ldg(scale + o), __ldg(scale + o + 1)};
  const float bo[2] = {__ldg(bias + o), __ldg(bias + o + 1)};
  float y[2 * NV];
#pragma unroll
  for (int v = 0; v < 2 * NV; ++v) y[v] = epi(a[v], s[v & 1], bo[v & 1]);
  if (MODE == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      *reinterpret_cast<float2*>(dst[v]) = make_float2(y[2 * v], y[2 * v + 1]);
  } else if (MODE == 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      *reinterpret_cast<__nv_bfloat162*>(dst[v]) =
          __halves2bfloat162(__float2bfloat16_rn(y[2 * v]), __float2bfloat16_rn(y[2 * v + 1]));
  } else {
    int r[2 * NV];
    bool slow = false;
#pragma unroll
    for (int v = 0; v < 2 * NV; ++v) {
      const float q = __fmul_rn(y[v], inv[v & 1]);
      slow |= needs_division(q);
      r[v] = q >= 128.5f ? 127 : clip_rint(q);
    }
    if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
      for (int v = 0; v < 2 * NV; ++v)
        if (needs_division(__fmul_rn(y[v], inv[v & 1])))
          r[v] = clip_rint(__fdiv_rn(y[v], __ldg(s_next + o + (v & 1))));
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
      *reinterpret_cast<uint16_t*>(dst[v]) =
          static_cast<uint16_t>((r[2 * v] & 0xff) | ((r[2 * v + 1] & 0xff) << 8));
  }
}

template <int MODE, bool POOL>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_i8_kernel(
    const int8_t* __restrict__ x,      // [B, H, W, C] int8
    const int8_t* __restrict__ wp,     // [C/32][ceil(Cout/128)][W_BYTES] (pack_conv3x3_weights)
    const float* __restrict__ scale,   // [Cout]
    const float* __restrict__ bias,    // [Cout]
    const float* __restrict__ s_next,  // [Cout] (MODE 2)
    void* __restrict__ out,            // [B, Ho, Wo, Cout]
    int H, int W, int C, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float inv_s[BN];                // rn(1 / s_next) of the block's channels
  __shared__ __align__(8) uint64_t full[STAGES];   // one mbarrier per stage (weights)
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const int oc0 = blockIdx.y * BN, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wg = warp >> 2, w = warp & 3;    // warpgroup, warp within it
  const int nch = C / CK;
  if (MODE == 2 && t < BN)
    inv_s[t] = oc0 + t < Cout ? reciprocal_or_nan(__ldg(s_next + oc0 + t)) : 0.f;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar0 + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage layout: halo [K half][HALO_H][HALO_W] x 16 bytes, then the chunk's
  // weights [tap][BN / 8][K half][8] x 16 bytes.
  auto load_stage = [&](int stage, int ch) {
    const uint32_t hs = sbase + stage * STAGE_BYTES;
    for (int i = t; i < HALO_H * HALO_W * 2; i += THREADS) {
      const int pix = i >> 1, h = i & 1;
      const int iy = ty0 - 1 + pix / HALO_W, ix = tx0 - 1 + pix % HALO_W;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const int8_t* src =
          ok ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + ch * CK + h * 16 : x;
      cp16(hs + h * HALF_BYTES + pix * 16, src, ok);
    }
    if (t == 0)
      bulk_load(hs + HALO_BYTES, wp + (static_cast<size_t>(ch) * gridDim.y + blockIdx.y) * W_BYTES,
                W_BYTES, bar0 + 8 * stage);
  };

  int acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0;

  // The stage of chunk ch + STAGES - 2 last held chunk ch - 2, whose wgmmas
  // every warpgroup waited for before this iteration's barrier.
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nch) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  pin(acc);
  for (int ch = 0; ch < nch; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // halo -> wgmma
    mbar_wait(bar0 + 8 * (ch % STAGES), (ch / STAGES) & 1);
    __syncthreads();
    if (ch + STAGES - 2 < nch) load_stage((ch + STAGES - 2) % STAGES, ch + STAGES - 2);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t hs = sbase + (ch % STAGES) * STAGE_BYTES;
    const uint64_t da = desc(hs + wg * 8 * 16, HALF_BYTES, HALO_W * 16);
    const uint64_t db = desc(hs + HALO_BYTES, 128, 256);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)     // descriptors count 16-byte units
        wgmma_s8(acc, da + (ky * HALO_W + kx), db + (ky * 3 + kx) * (TAP_BYTES >> 4));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin(acc);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                           // the staging area reuses the ring

  // Epilogue. acc[4j + 2hf + e]: M row 16w + g + 8hf = tile pixel
  // (2w + hf, 8 wg + g), channel 8j + 2q + e.
  constexpr int ES = MODE == 0 ? 4 : (MODE == 1 ? 2 : 1);
  constexpr int RS = BN * ES + 16;           // staging row stride (bytes)
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (oc0 + 8 * j >= Cout) break;          // warp-uniform: Cout % 64 == 0
    const int c = 8 * j + 2 * q, o = oc0 + c;
    if (POOL) {
      // rows of the window in the thread, columns g and g ^ 1 in lanes 4
      // apart; both lanes of a pair stage the same values
      int m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m[e] = max(acc[4 * j + e], acc[4 * j + 2 + e]);
        m[e] = max(m[e], __shfl_xor_sync(0xffffffffu, m[e], 4));
      }
      unsigned char* const dst[1] = {smem + (w * (TW / 2) + 4 * wg + (g >> 1)) * RS + c * ES};
      stage<MODE, 1>(dst, m, o, scale, bias, s_next, inv_s + c);
    } else {
      unsigned char* const dst[2] = {smem + (2 * w * TW + 8 * wg + g) * RS + c * ES,
                                     smem + ((2 * w + 1) * TW + 8 * wg + g) * RS + c * ES};
      const int a[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
      stage<MODE, 2>(dst, a, o, scale, bias, s_next, inv_s + c);
    }
  }
  __syncthreads();

  const int nbytes = min(BN, Cout - oc0) * ES;   // a multiple of 64
  constexpr int CHUNKS = BN * ES / 16;
  constexpr int PH = POOL ? TH / 2 : TH, PW = POOL ? TW / 2 : TW;
  const int Ho = POOL ? H / 2 : H, Wo = POOL ? W / 2 : W;
  const int gy0 = POOL ? ty0 / 2 : ty0, gx0 = POOL ? tx0 / 2 : tx0;
  for (int i = t; i < PH * PW * CHUNKS; i += THREADS) {
    const int pix = i / CHUNKS, k = i % CHUNKS;
    const int gy = gy0 + pix / PW, gx = gx0 + pix % PW;
    if (gy >= Ho || gx >= Wo || k * 16 >= nbytes) continue;
    unsigned char* dst = static_cast<unsigned char*>(out) +
        (((static_cast<size_t>(b) * Ho + gy) * Wo + gx) * Cout + oc0) * ES + k * 16;
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(smem + pix * RS + k * 16);
  }
}

template <int MODE, bool POOL>
int launch(dim3 grid, cudaStream_t st, const void* x, const void* w, const void* scale,
           const void* bias, const void* s_next, void* out, int H, int W, int C, int Cout) {
  // the shared-memory limit is an attribute of the function on each device
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    e = cudaFuncSetAttribute(
        conv3x3_i8_kernel<MODE, POOL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  conv3x3_i8_kernel<MODE, POOL><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s_next), out, H, W, C, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// w: [C/32][ceil(Cout/128)][36,864] int8 (ops/conv_hpack.pack_conv3x3_weights).
// mode: 0 = f32 out, 1 = bf16 out, 2 = int8 requant with s_next; pool: 0/1.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv3x3_i8(const void* x, const void* w, const void* scale,
                          const void* bias, const void* s_next, void* out,
                          int B, int H, int W, int C, int Cout, int mode, int pool,
                          void* stream) {
  if (C % CK != 0 || Cout % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (Cout + BN - 1) / BN, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (pool ? 1 : 0)) {
    case 0: return launch<0, false>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout);
    case 1: return launch<0, true>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout);
    case 2: return launch<1, false>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout);
    case 3: return launch<1, true>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout);
    case 4: return launch<2, false>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout);
    case 5: return launch<2, true>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
