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
// f32 (--opt_lvl 0, conv0_f_kernel): the sum runs in one fixed order, taps
// (kh, kw, c) row-major, each step __fadd_rn(acc, __fmul_rn(x, w)) so nvcc
// cannot contract it into an FMA (the build also passes -fmad=false). The
// plain PyTorch version in ops/conv_stage1.py (conv0_f_plain) sums in that
// same order with separate f32 multiplies and adds, so kernel and plain are
// bit-equal on the card. Its 11.1 G multiply-adds are 22.2 G CUDA-core
// instructions, about 0.66 ms at the card's f32 issue rate: instruction-bound
// (3xTF32 on the tensor cores would be later work).
// Design of the f32 kernel, the tiling of kernel A without the int8 packing:
//   * a block owns 32 pooled pixels of one pooled row x all 64 channels; its
//     4 x 66 input pixels (3 channels) are staged once in shared memory as
//     f32, with the conv's zero padding written there; the BN-folded weights
//     [27][64] (f32) are staged too;
//   * thread t computes 8 consecutive channels of one pooled pixel for all
//     four pool phases (32 f32 sums), so the 8 threads of a pixel store its
//     64-channel row contiguously: two 16-byte stores per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OC = 64;        // output channels (VGG conv0)
constexpr int CI = 3;         // input channels
constexpr int TPX = 32;       // pooled pixels per block
constexpr int CPT = 8;        // channels per thread
constexpr int THREADS = TPX * (OC / CPT);   // 256
constexpr int XS_W = 2 * TPX + 2;           // staged input columns

__global__ void __launch_bounds__(THREADS) conv0_f_kernel(
    const float* __restrict__ x,      // [B, H, W, 3]
    const float* __restrict__ w,      // [27][64]: (kh, kw, c) x out channel
    const float* __restrict__ bias,   // [64]
    float* __restrict__ out,          // [B, H/2, W/2, 64]
    int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z, po = blockIdx.y, pw0 = blockIdx.x * TPX;
  __shared__ float xs[4][XS_W][CI];
  __shared__ __align__(16) float ws[9 * CI * OC];
  const int t = threadIdx.x;

  for (int i = t; i < 9 * CI * OC; i += THREADS) ws[i] = w[i];
  for (int i = t; i < 4 * XS_W * CI; i += THREADS) {
    const int r = i / (XS_W * CI), rem = i % (XS_W * CI);
    const int c = rem / CI, ch = rem % CI;
    const int iy = 2 * po - 1 + r, ix = 2 * pw0 - 1 + c;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = x[((static_cast<size_t>(b) * H + iy) * W + ix) * CI + ch];
    xs[r][c][ch] = v;
  }
  __syncthreads();

  const int cg = t % (OC / CPT), px = t / (OC / CPT);
  const int pw = pw0 + px;
  if (pw >= Wo) return;

  float acc[4][CPT];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[ph][j] = 0.f;

#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const float* wr = &ws[((ky * 3 + kx) * CI + c) * OC + cg * CPT];
        const float4 wa = *reinterpret_cast<const float4*>(wr);
        const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
        const float wv[CPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float xv = xs[p + ky][2 * px + q + kx][c];
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[p * 2 + q][j] = __fadd_rn(acc[p * 2 + q][j], __fmul_rn(xv, wv[j]));
          }
        }
      }
    }
  }

  float y[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const float m = fmaxf(fmaxf(acc[0][j], acc[1][j]), fmaxf(acc[2][j], acc[3][j]));
    const float v = __fadd_rn(m, __ldg(bias + cg * CPT + j));
    y[j] = v > 0.f ? v : 0.f;
  }

  float4* dst = reinterpret_cast<float4*>(
      out + ((static_cast<size_t>(b) * Ho + po) * Wo + pw) * OC + cg * CPT);
  dst[0] = make_float4(y[0], y[1], y[2], y[3]);
  dst[1] = make_float4(y[4], y[5], y[6], y[7]);
}

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

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 x and out, 1 = bf16 x and out. w [27][64] and bias [64] f32.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv0_f(const void* x, const void* w, const void* bias, void* out,
                       int B, int H, int W, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  switch (mode) {
    case 0:
      conv0_f_kernel<<<dim3((W / 2 + TPX - 1) / TPX, H / 2, B), THREADS, 0, st>>>(
          static_cast<const float*>(x), wp, bp, static_cast<float*>(out), H, W);
      break;
    case 1:
      conv0_f_bf16_kernel<<<dim3((W / 2 + TC_PX - 1) / TC_PX, H / 2, B), THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), wp, bp,
          static_cast<__nv_bfloat16*>(out), H, W);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
