// Kernel C: float VGG conv0 (3 -> 64) + folded-BN bias + ReLU + 2x2 maxpool.
//
// Replaces the Pallas TPU kernel of the float route (int8 off) of the JAX
// package: vqa_tpu/ops/conv_stage1.py:_conv0_pallas with its body variants
// _kernel (the default), _kernel_v2 and _kernel_wide. Those rewrite the conv
// as a space-to-depth K=108 dot to feed the 128-deep MXU; on the H100 a
// direct 3x3 conv over the four pool phases gives the same sums.
//
// Arithmetic kept from the TPU kernel: the 27 products of x.dtype operands
// accumulate in f32, the 2x2 pool is a max over the four phases' f32 sums,
// then + b (b rounded to x.dtype by the caller, then widened), ReLU, and one
// rounding to x.dtype at the store.
//
// bf16 (the training route, conv0_f_bf16_kernel): bound by bytes. At b32 @
// 448^2 it reads 38.5 MB and writes 205.5 MB, 73 us at 3.35 TB/s, while its
// 22 GFLOP are ~22 us on the bf16 tensor cores. Design:
//   * implicit GEMM on mma.sync.m16n8k16 bf16 with f32 sums: K = the 27 taps
//     (kh, kw, c) zero-padded to 32 (two k-steps), N = 64, M = 4 pool phases
//     x pooled pixels. A warp's two m16 tiles order their rows so that lane
//     group g holds the four phases of pooled pixel g (rows g and g + 8 are
//     the phase's columns, the two tiles its rows): the phase max is taken in
//     registers. mma.sync, not wgmma: the tensor cores are not the limit, and
//     wgmma's 64-row tiles would only raise the registers held per thread;
//   * a block owns 128 pooled pixels of one pooled row: its 4 x 258 input
//     pixels (bf16) and the weights, already in B-fragment order, are staged
//     in shared memory once; each warp builds its A fragments from the staged
//     pixels with one table of tap offsets per lane;
//   * per 8 output channels a lane holds 8 f32 sums, takes the max, adds the
//     bias, applies ReLU and rounds to bf16 at once (few registers, many
//     blocks in flight); the 128 x 64 bf16 tile is staged in shared memory
//     and written with 16-byte coalesced stores (16 KB contiguous per block).
//     No atomics: deterministic.
// The tensor core sums in another order than conv0_f_plain's fixed (kh, kw,
// c) order, so bf16 is held to a bound instead of bit-equality:
//   |kernel - plain| <= ulp_bf16(|plain|) + 2^-17 * sum_taps |x * w|
// (bf16 x bf16 products are exact in f32, only the order of ~32 f32 additions
// differs, then one bf16 rounding: ops/conv_stage1.conv0_f_bound).
//
// f32 (--opt_lvl 0, conv0_f32_kernel): 3xTF32 on wgmma. On the CUDA cores,
// as separate f32 multiplies and adds, its 11.1 G multiply-adds at b32 @
// 448^2 are bound by the instruction rate (1.06 ms). Here each f32 operand
// v is split into two TF32 values, hi = rna_tf32(v) and lo = rna_tf32(v -
// hi) (v - hi is exact), and each product x * w is taken as lo_x * hi_w +
// hi_x * lo_w + hi_x * hi_w on the tensor cores with f32 sums: the dropped
// lo_x * lo_w and the split leave <= 3 * 2^-22 |x * w| per product,
// f32-level accuracy. Three MMAs
// per product make 66.6 GFLOP at that shape, 0.135 ms at the TF32 peak,
// under the 0.146 ms its 488 MB take at 3.35 TB/s: the bytes bound it, and
// the output is 84% of them. The tensor cores sum in their own order and
// may truncate, so f32 is held to a bound, not to bit-equality:
//   |kernel - plain| <= ulp_f32(|plain|) + 2^-15 * sum_taps |x * w|
// (ops/conv_stage1.conv0_f_bound derives it). Design:
//   * implicit GEMM with the weights as M (64 output channels) and conv
//     columns as N: a warpgroup's wgmma.m64n64k8.f32.tf32 takes A (the
//     weights) from registers, split once by the wrapper
//     (ops/conv_stage1.pack_conv0_f32_weights: 40 registers a thread, for the
//     whole kernel), and B (the activations) from shared memory;
//   * K = 9 taps x 4 slots (c0, c1, c2, 0), two taps a k-step (5 k-steps, tap
//     9 zero). The input window is stored as 16-byte pixels (c0, c1, c2, 0),
//     once as hi and once as lo, so B for tap (ky, kx) is the window itself
//     from another start address: core matrix = 8 consecutive pixels (SBO 128
//     bytes), the k-step's second tap LBO bytes after the first. No im2col,
//     and every value is split once, not once per tap;
//   * one pooled row (2 conv rows x 64 conv columns) is two accumulators of
//     32 registers; per k-step three wgmmas go into each, small terms first
//     (lo_x * hi_w, hi_x * lo_w, then hi_x * hi_w), in a fixed order: no
//     atomics, deterministic. Thread (warp w, lane 4g + q) holds channels
//     16w + g and 16w + g + 8 at conv columns 8j + 2q, +1 of both rows: the
//     2x2 pool is a max over four of its own registers, then + bias
//     (__fadd_rn) and ReLU;
//   * a block (one warpgroup, three per SM) is persistent and walks over
//     units of 8 conv rows x 64 conv columns; each unit's 10 x 66 x 3 input
//     window comes by cp.async (zero fill = the conv's padding) two units
//     ahead, and is split into (hi, lo) while the unit before it multiplies
//     (two window buffer sets);
//   * each pooled row's 32 x 64 f32 outputs are staged in shared memory
//     (rows 8 words apart mod 32 banks: conflict-free) and written as 8 KB
//     contiguous with 16-byte stores.
// What bounds it: the wgmmas first. K is padded from 27 to 40, so they do
// 98.6 GFLOP at b32 @ 448^2, 0.2 ms at the TF32 peak; the unit's fetch,
// split and stores come after. wgmma, not mma.sync: versions of this body
// on mma.sync m16n8k8 were held back by that path's lower TF32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OC = 64;        // output channels (VGG conv0)
constexpr int CI = 3;         // input channels
constexpr int THREADS = 256;

constexpr int TC_PX = 128;                  // pooled pixels per block (bf16 kernel)
constexpr int TC_XW = 2 * TC_PX + 2;        // staged input columns
constexpr int TC_RS = OC * 2 + 16;          // staging row stride (bytes)

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__global__ void __launch_bounds__(THREADS) conv0_f_bf16_kernel(
    const __nv_bfloat16* __restrict__ x,   // [B, H, W, 3]
    const float* __restrict__ w,           // [27][64], values already bf16
    const float* __restrict__ bias,        // [64], already rounded to bf16
    __nv_bfloat16* __restrict__ out,       // [B, H/2, W/2, 64]
    int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z, po = blockIdx.y, pw0 = blockIdx.x * TC_PX;
  __shared__ unsigned short xs[4 * TC_XW * CI + 1];         // last entry: 0
  __shared__ uint2 wf[2][OC / 8][32];                       // B fragments
  __shared__ __align__(16) unsigned char st[TC_PX * TC_RS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;

  // B fragment of k-step s, n-tile nt, lane (g, q): b.x = w[16s + 2q, +1][8nt + g],
  // b.y = w[16s + 8 + 2q, +1][8nt + g]; k >= 27 is zero.
  for (int i = t; i < 2 * (OC / 8) * 32; i += THREADS) {
    const int s = i >> 8, nt = (i >> 5) & 7, ln = i & 31;
    const int n = nt * 8 + (ln >> 2), k0 = 16 * s + 2 * (ln & 3);
    __nv_bfloat16 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + (j & 1) + (j >> 1) * 8;
      v[j] = __float2bfloat16_rn(k < 9 * CI ? w[k * OC + n] : 0.f);
    }
    wf[s][nt][ln] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
  const unsigned short* xg = reinterpret_cast<const unsigned short*>(x);
  for (int i = t; i < 4 * TC_XW * CI; i += THREADS) {
    const int r = i / (TC_XW * CI), rem = i % (TC_XW * CI);
    const int iy = 2 * po - 1 + r, ix = 2 * pw0 - 1 + rem / CI;
    xs[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                ? xg[((static_cast<size_t>(b) * H + iy) * W + ix) * CI + rem % CI] : 0;
  }
  if (t == 0) xs[4 * TC_XW * CI] = 0;
  __syncthreads();

  // A fragment k values of this lane: {2q, 2q+1, 8+2q, 9+2q} + 16 s, as
  // offsets into xs from a pixel's (dy, col) base; k >= 27 reads the zero.
  int koff[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * q + (j & 1);
    const int ky = k / 9, kx = (k % 9) / CI, c = k % CI;
    koff[j] = k < 9 * CI ? (ky * TC_XW + kx) * CI + c : -1;
  }
  const int zero = 4 * TC_XW * CI;

  for (int grp = warp; grp < TC_PX / 8; grp += THREADS / 32) {
    // rows of tile mt: g -> phase (mt, 0), g + 8 -> phase (mt, 1) of pooled
    // pixel 8 grp + g, i.e. input (row mt + ky, column 2 (8 grp + g) + dx + kx)
    uint32_t a[2][2][4];                    // [k-step][mt][reg]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int base = (mt * TC_XW + 2 * (8 * grp + g) + dx) * CI;
        unsigned short v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = xs[koff[j] < 0 ? zero : base + koff[j]];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          a[s][mt][dx] = v[4 * s] | (static_cast<uint32_t>(v[4 * s + 1]) << 16);
          a[s][mt][2 + dx] = v[4 * s + 2] | (static_cast<uint32_t>(v[4 * s + 3]) << 16);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < OC / 8; ++nt) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint2 bf = wf[s][nt][lane];
        mma_bf16(acc[0], a[s][0], bf);
        mma_bf16(acc[1], a[s][1], bf);
      }
      // acc[mt][dx * 2 + j]: phase (mt, dx), channel 8 nt + 2q + j
      __nv_bfloat16 y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float m = fmaxf(fmaxf(acc[0][j], acc[0][2 + j]), fmaxf(acc[1][j], acc[1][2 + j]));
        const float v = __fadd_rn(m, __ldg(bias + nt * 8 + 2 * q + j));
        y[j] = __float2bfloat16_rn(v > 0.f ? v : 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(st + (8 * grp + g) * TC_RS + (nt * 8 + 2 * q) * 2) =
          __halves2bfloat162(y[0], y[1]);
    }
  }
  __syncthreads();

  const int npx = min(TC_PX, Wo - pw0);
  unsigned char* dst = reinterpret_cast<unsigned char*>(
      out + ((static_cast<size_t>(b) * Ho + po) * Wo + pw0) * OC);
  for (int i = t; i < npx * (OC * 2 / 16); i += THREADS) {
    const int px = i >> 3, k = i & 7;
    *reinterpret_cast<int4*>(dst + i * 16) =
        *reinterpret_cast<const int4*>(st + px * TC_RS + k * 16);
  }
}

// f32 body (3xTF32 on wgmma). A block is one warpgroup; a unit is 8 conv
// rows x 64 conv columns (4 x 32 pooled pixels) of one image. Shared memory,
// twice (by unit parity): the raw input window that cp.async fills (10 rows
// x 66 columns x 3 channels) and the same window as hi and as lo pixels (c0,
// c1, c2, 0) of 16 bytes with one zero pixel after each; then the staging
// rows of one pooled row's outputs.
constexpr int F_THREADS = 128;
constexpr int F_UR = 8, F_UC = 64;               // conv rows and columns of a unit
constexpr int F_WR = F_UR + 2, F_WC = F_UC + 2;  // window rows and columns (10 x 66)
constexpr int F_NPIX = F_WR * F_WC;              // window pixels (660)
constexpr int F_NRAW = F_NPIX * CI;              // raw values (1980)
constexpr int F_PRE = (F_NRAW + F_THREADS - 1) / F_THREADS;  // values a thread fetches (16)
constexpr int F_KS = 5;                          // k-steps: taps 2j, 2j + 1 x 4 slots
constexpr int F_RAW_BYTES = (F_NRAW * 4 + 127) / 128 * 128;
constexpr int F_WIN_BYTES = ((F_NPIX + 1) * 16 + 127) / 128 * 128;
constexpr int F_RS = (OC + 8) * 4;               // staging row stride: 8 words mod 32
constexpr int F_ST_BYTES = F_UC / 2 * F_RS;      // one pooled row of the unit
constexpr int F_BUF = F_RAW_BYTES + 2 * F_WIN_BYTES;
constexpr int F_SMEM = 2 * F_BUF + F_ST_BYTES;
static_assert(F_RS % 128 == 32, "staging rows must lie 8 banks apart");
static_assert(F_BUF % 128 == 0, "the buffers must stay aligned");

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);      // the low 13 bits, explicitly zero
}

// 4 bytes global -> shared, or 4 zero bytes (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Shared-memory matrix descriptor, canonical K-major layout without swizzle:
// `lbo` bytes to the next 16 bytes of K, `sbo` bytes to the next 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A (64 x 8 tf32, registers) x B (8 x 64 tf32, shared memory), issued
// asynchronously by the warpgroup; `acc` = 0 ignores d's old value.
__device__ __forceinline__ void wgmma_tf32(float* d, const float4& a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "l"(db), "r"(acc));
}

// Keeps the compiler from moving other accesses of the accumulators across
// the wgmma fences and waits (the asm above does not say when they land).
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(F_THREADS, 3) conv0_f32_kernel(
    const float* __restrict__ x,      // [B, H, W, 3]
    const float4* __restrict__ wa,    // [128 threads][hi, lo][5 k-steps] A fragments
    const float* __restrict__ bias,   // [64]
    float* __restrict__ out,          // [B, H/2, W/2, 64]
    int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  // buffer set k: raw window, hi window, lo window
  auto raw = [&](int k) { return reinterpret_cast<float*>(smem + k * F_BUF); };
  auto xh = [&](int k) { return reinterpret_cast<float4*>(smem + k * F_BUF + F_RAW_BYTES); };
  auto xl = [&](int k) { return reinterpret_cast<float4*>(smem + k * F_BUF + F_RAW_BYTES + F_WIN_BYTES); };
  if (t < 2) xh(t)[F_NPIX] = xl(t)[F_NPIX] = make_float4(0.f, 0.f, 0.f, 0.f);
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // the weights (M = 64 output channels) are the A operand, in registers for
  // the whole kernel: this thread's fragment of each k-step, hi and lo
  float4 ah[F_KS], al[F_KS];
#pragma unroll
  for (int j = 0; j < F_KS; ++j) {
    ah[j] = __ldg(wa + t * 2 * F_KS + j);
    al[j] = __ldg(wa + t * 2 * F_KS + F_KS + j);
  }
  // this thread's output channels: M rows 16 warp + g and 16 warp + g + 8
  const int ch = 16 * warp + g;
  const float b0 = __ldg(bias + ch), b1 = __ldg(bias + ch + 8);

  const int Ho = H / 2, Wo = W / 2;
  const int nr = (H + F_UR - 1) / F_UR, nc = (W + F_UC - 1) / F_UC;
  const int nunits = B * nr * nc, step = gridDim.x;
  // unit u = (b, conv rows 8 ur .., conv columns 64 uc ..): its input rows
  // 8 ur - 1 .. 8 ur + 8, columns 64 uc - 1 .. 64 uc + 64 (zero outside) go
  // to raw window k by cp.async
  auto fetch = [&](int u, int k) {
    const int b = u / (nr * nc), rem = u % (nr * nc);
    const int iy0 = F_UR * (rem / nc) - 1, ix0 = F_UC * (rem % nc) - 1;
    float* const dst = raw(k);
#pragma unroll 4
    for (int i = 0; i < F_PRE; ++i) {
      const int e = t + F_THREADS * i, r = e / (F_WC * CI), c3 = e % (F_WC * CI);
      const int iy = iy0 + r, ix = ix0 + c3 / CI;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      if (e < F_NRAW)
        cp_async4_or_zero(dst + e, in ? x + (static_cast<size_t>(b * H + iy) * W + ix) * CI + c3 % CI
                                      : x, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // raw window k, landed, -> hi and lo windows k, for the wgmmas (async proxy)
  auto split = [&](int k) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const float* const src = raw(k);
    float4* const dh = xh(k);
    float4* const dl = xl(k);
    for (int p = t; p < F_NPIX; p += F_THREADS) {
      float hi[3], lo[3];
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const float v = src[p * CI + c];
        hi[c] = tf32_rna(v);
        lo[c] = tf32_rna(__fsub_rn(v, hi[c]));
      }
      dh[p] = make_float4(hi[0], hi[1], hi[2], 0.f);
      dl[p] = make_float4(lo[0], lo[1], lo[2], 0.f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  // Unit i of this block (u = blockIdx.x + i step) uses buffer set i & 1.
  // Its window is split while unit i - 1 multiplies, and unit i + 1's raw
  // window is fetched while unit i multiplies.
  if (blockIdx.x < nunits) {
    fetch(blockIdx.x, 0);
    split(0);
    if (blockIdx.x + step < nunits) fetch(blockIdx.x + step, 1);
  }

#pragma unroll 1
  for (int u = blockIdx.x, k = 0; u < nunits; u += step, k ^= 1) {
    const int b = u / (nr * nc), rem = u % (nr * nc);
    const int po0 = (F_UR / 2) * (rem / nc), pw0 = (F_UC / 2) * (rem % nc);
    const uint32_t s_xh = s_base + k * F_BUF + F_RAW_BYTES, s_xl = s_xh + F_WIN_BYTES;
    unsigned char* const sb = smem + 2 * F_BUF;

#pragma unroll 1
    for (int pr = 0; pr < F_UR / 2; ++pr) {
      const int po = po0 + pr;
      if (po >= Ho) break;                           // uniform over the block
      // conv row 2 pr + h of the unit: N column n = conv column n, the K-major
      // B operand's row n = window pixel (2 pr + h + ky, n + kx) of tap (ky,
      // kx): core matrix cn is 8 consecutive pixels (SBO = 128 bytes). K-step
      // j holds taps 2j and 2j + 1 (tap = 3 ky + kx), 4 slots each (c0, c1,
      // c2, 0): the second 16 bytes of K lie LBO after the first; tap 9 has
      // zero weights and reads the next pixel.
      float acc[2][32];
      // the row pair's descriptors (SBO 128 bytes); each tap adds its start
      // (16-byte units) and its k-step's LBO to them
      const uint64_t dxh = desc(s_xh + 2 * pr * F_WC * 16, 0, 128);
      const uint64_t dxl = dxh + (F_WIN_BYTES >> 4);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < F_KS; ++j) {
          const int t0 = 2 * j, t1 = 2 * j + 1;
          const int off0 = (t0 / 3) * F_WC + t0 % 3;
          const uint64_t lbo = t1 < 9 ? (t1 / 3) * F_WC + t1 % 3 - off0 : 1;
          const uint64_t add = (lbo << 16) + h * F_WC + off0;
          const uint64_t bxh = dxh + add, bxl = dxl + add;
          wgmma_tf32(acc[h], ah[j], bxl, j);           // lo_x * hi_w (k-step 0 starts from 0)
          wgmma_tf32(acc[h], al[j], bxh, 1);           // hi_x * lo_w
          wgmma_tf32(acc[h], ah[j], bxh, 1);           // hi_x * hi_w
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (pr == 0 && u + step < nunits) {
        // while the first pooled row multiplies: the next unit's window,
        // then the raw window of the unit after it (its buffer was split
        // one unit ago)
        split(k ^ 1);
        if (u + 2 * step < nunits) fetch(u + 2 * step, k);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(acc[0]);
      pin(acc[1]);

      // acc[h][4 j + 2 r + e]: conv row 2 pr + h, conv column 8 j + 2 q + e,
      // channel ch + 8 r: the 2 x 2 window of pooled column 4 j + q lies in
      // this thread
#pragma unroll
      for (int j = 0; j < F_UC / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m = fmaxf(fmaxf(acc[0][4 * j + 2 * r], acc[0][4 * j + 2 * r + 1]),
                                fmaxf(acc[1][4 * j + 2 * r], acc[1][4 * j + 2 * r + 1]));
          const float v = __fadd_rn(m, r ? b1 : b0);
          *reinterpret_cast<float*>(sb + (4 * j + q) * F_RS + (ch + 8 * r) * 4) = v > 0.f ? v : 0.f;
        }
      }
      __syncthreads();
      // the pooled row's pixels are one contiguous run of the output
      const int npx = min(F_UC / 2, Wo - pw0);
      int4* const gout = reinterpret_cast<int4*>(out + ((static_cast<size_t>(b) * Ho + po) * Wo + pw0) * OC);
#pragma unroll
      for (int it = 0; it < F_UC / 2 * OC / 4 / F_THREADS; ++it) {
        const int i = t + F_THREADS * it, px = i >> 4;
        if (px < npx) gout[i] = *reinterpret_cast<const int4*>(sb + px * F_RS + (i & 15) * 16);
      }
      __syncthreads();                               // the staging rows are free again
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

int launch_f32(const float* x, const float4* wa, const float* bias, float* out,
               int B, int H, int W, cudaStream_t st) {
  // per device: the shared-memory attribute (> 48 KB) and the number of
  // blocks that fit on the card at once
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = dev < MAX_DEVICES ? resident[dev] : 0;
  if (blocks == 0) {
    e = cudaFuncSetAttribute(conv0_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv0_f32_kernel, F_THREADS, F_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = sms * per_sm;
    if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < MAX_DEVICES) resident[dev] = blocks;
  }
  const int units = B * ((H + F_UR - 1) / F_UR) * ((W + F_UC - 1) / F_UC);
  if (units == 0) return static_cast<int>(cudaSuccess);
  conv0_f32_kernel<<<units < blocks ? units : blocks, F_THREADS, F_SMEM, st>>>(
      x, wa, bias, out, B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 x and out, w the B fragments of ops/conv_stage1.
// pack_conv0_f32_weights ([4][8][32][4] f32); 1 = bf16 x and out, w [27][64]
// f32. bias [64] f32. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv0_f(const void* x, const void* w, const void* bias, void* out,
                       int B, int H, int W, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  switch (mode) {
    case 0:
      return launch_f32(static_cast<const float*>(x), static_cast<const float4*>(w), bp,
                        static_cast<float*>(out), B, H, W, st);
    case 1:
      conv0_f_bf16_kernel<<<dim3((W / 2 + TC_PX - 1) / TC_PX, H / 2, B), THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w), bp,
          static_cast<__nv_bfloat16*>(out), H, W);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
