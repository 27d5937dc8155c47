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
// rounding to x.dtype at the store. The sum runs in one fixed order, taps
// (kh, kw, c) row-major, each step __fadd_rn(acc, __fmul_rn(x, w)) so nvcc
// cannot contract it into an FMA (the build also passes -fmad=false). The
// plain PyTorch version in ops/conv_stage1.py (conv0_f_plain) sums in that
// same order with separate f32 multiplies and adds, so kernel and plain are
// bit-equal on the card.
//
// What bounds it on the H100: at b32 @ 448^2 it reads 38.5 MB (bf16) and
// writes 205.5 MB, 73 us at 3.35 TB/s; its 11.1 G multiply-adds, kept as
// separate f32 multiplies and adds for bit-equality, are 22.2 G CUDA-core
// instructions, about 0.66 ms at the card's f32 issue rate. So this simple
// kernel is instruction-bound; tensor cores (bf16 mma with f32 sums) would
// change the summation order and are later work.
// Design, the tiling of kernel A without the int8 packing:
//   * a block owns 32 pooled pixels of one pooled row x all 64 channels; its
//     4 x 66 input pixels (3 channels) are staged once in shared memory as
//     f32, with the conv's zero padding written there; the BN-folded weights
//     [27][64] (f32) are staged too;
//   * thread t computes 8 consecutive channels of one pooled pixel for all
//     four pool phases (32 f32 sums), so the 8 threads of a pixel store its
//     64-channel row contiguously: one 16-byte store per thread for bf16, two
//     for f32.

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) conv0_f_kernel(
    const T* __restrict__ x,          // [B, H, W, 3]
    const float* __restrict__ w,      // [27][64]: (kh, kw, c) x out channel
    const float* __restrict__ bias,   // [64], already rounded to T
    T* __restrict__ out,              // [B, H/2, W/2, 64]
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
      v = to_f32(x[((static_cast<size_t>(b) * H + iy) * W + ix) * CI + ch]);
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

  const size_t base = ((static_cast<size_t>(b) * Ho + po) * Wo + pw) * OC + cg * CPT;
  if constexpr (sizeof(T) == 4) {
    float4* dst = reinterpret_cast<float4*>(out + base);
    dst[0] = make_float4(y[0], y[1], y[2], y[3]);
    dst[1] = make_float4(y[4], y[5], y[6], y[7]);
  } else {
    __align__(16) __nv_bfloat16 h[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) h[j] = __float2bfloat16_rn(y[j]);
    *reinterpret_cast<int4*>(out + base) = *reinterpret_cast<const int4*>(h);
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
  const dim3 grid((W / 2 + TPX - 1) / TPX, H / 2, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  switch (mode) {
    case 0:
      conv0_f_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), wp, bp, static_cast<float*>(out), H, W);
      break;
    case 1:
      conv0_f_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), wp, bp,
          static_cast<__nv_bfloat16*>(out), H, W);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
