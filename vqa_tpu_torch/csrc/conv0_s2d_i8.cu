// Kernel A: int8 VGG conv0 (3 -> 64) + dequant + bias + ReLU + 2x2 maxpool.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   vqa_tpu/ops/conv_stage1.py:_kernel_i8            (plain epilogue, x.dtype out)
//   vqa_tpu/ops/conv_stem.py:_kernel_conv0_packed    (requant epilogue, int8 out)
// Both compute the same int32 sums: the TPU kernels rewrite the conv as a
// space-to-depth K=108 dot so the 128-deep MXU is fed; here a direct 3x3 conv
// over the four pool phases gives the same integers.
//
// What bounds it on the H100: bytes. Each pooled output channel costs 4
// phases x 27 int8 MACs, i.e. 108 MACs per 1-2 stored bytes, far below the
// card's int8 ridge. At the serving shape (b32 @ 448^2) the 19 MB int8 image
// is read once and 205 MB of bf16 (or 103 MB of int8) is written.
// Design against that:
//   * a block owns 32 pooled pixels of one pooled row x all 64 channels; its
//     4 x 66 input pixels are staged once in shared memory as char4 words
//     (channel 3 zero), so each input byte is read from device memory about
//     twice (neighbouring pooled rows share one input row);
//   * thread t computes 8 consecutive channels of one pooled pixel, so the 8
//     threads of a pixel store its 64-channel row contiguously: one 16-byte
//     store per thread for bf16, two for f32, one 8-byte store for int8;
//   * the tap loop runs __dp4a on (c0, c1, c2, 0) words, and the 2x2 pool is a
//     max over the four phase accumulators in int32 before the epilogue, which
//     is exact because every epilogue step is non-decreasing (scale > 0).
//
// Epilogue, bit-for-bit the plain PyTorch version in ops/conv_stage1.py:
//   y = relu(__fadd_rn(__fmul_rn(float(max_acc), scale[o]), bias[o]))
//   MODE 0: store f32, MODE 1: store bf16 (round to nearest even),
//   MODE 2: store int8 clip(rint(__fdiv_rn(y, s1[o])), -127, 127).
// The _rn intrinsics keep nvcc from contracting into an FMA; division (not a
// reciprocal) and rint (half to even) follow the JAX package's CPU fallbacks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OC = 64;        // output channels (VGG conv0)
constexpr int TPX = 32;       // pooled pixels per block
constexpr int CPT = 8;        // channels per thread
constexpr int THREADS = TPX * (OC / CPT);   // 256
constexpr int XS_W = 2 * TPX + 2;           // staged input columns

template <int MODE>
__global__ void __launch_bounds__(THREADS) conv0_s2d_i8_kernel(
    const int8_t* __restrict__ x,      // [B, H, W, 3] int8
    const int* __restrict__ w,         // [9][64] char4 words (c0, c1, c2, 0)
    const float* __restrict__ scale,   // [64] dequant scale
    const float* __restrict__ bias,    // [64]
    const float* __restrict__ s1,      // [64] requant scale (MODE 2)
    void* __restrict__ out,            // [B, H/2, W/2, 64]
    int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z, po = blockIdx.y, pw0 = blockIdx.x * TPX;
  __shared__ int xs[4][XS_W];
  __shared__ __align__(16) int ws[9 * OC];
  const int t = threadIdx.x;

  for (int i = t; i < 9 * OC; i += THREADS) ws[i] = w[i];
  for (int i = t; i < 4 * XS_W; i += THREADS) {
    const int r = i / XS_W, c = i % XS_W;
    const int iy = 2 * po - 1 + r, ix = 2 * pw0 - 1 + c;
    int v = 0;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const int8_t* p = x + ((static_cast<size_t>(b) * H + iy) * W + ix) * 3;
      v = static_cast<int>(static_cast<uint8_t>(p[0]))
          | (static_cast<int>(static_cast<uint8_t>(p[1])) << 8)
          | (static_cast<int>(static_cast<uint8_t>(p[2])) << 16);
    }
    xs[r][c] = v;
  }
  __syncthreads();

  const int cg = t % (OC / CPT), px = t / (OC / CPT);
  const int pw = pw0 + px;
  if (pw >= Wo) return;

  int acc[4][CPT];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[ph][j] = 0;

#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int4 wa = *reinterpret_cast<const int4*>(&ws[(ky * 3 + kx) * OC + cg * CPT]);
      const int4 wb = *reinterpret_cast<const int4*>(&ws[(ky * 3 + kx) * OC + cg * CPT + 4]);
      const int wv[CPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int xv = xs[p + ky][2 * px + q + kx];
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[p * 2 + q][j] = __dp4a(xv, wv[j], acc[p * 2 + q][j]);
        }
      }
    }
  }

  float y[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int o = cg * CPT + j;
    const int m = max(max(acc[0][j], acc[1][j]), max(acc[2][j], acc[3][j]));
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(m), __ldg(scale + o)), __ldg(bias + o));
    y[j] = v > 0.f ? v : 0.f;
  }

  const size_t base = ((static_cast<size_t>(b) * Ho + po) * Wo + pw) * OC + cg * CPT;
  if (MODE == 0) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + base);
    dst[0] = make_float4(y[0], y[1], y[2], y[3]);
    dst[1] = make_float4(y[4], y[5], y[6], y[7]);
  } else if (MODE == 1) {
    __align__(16) __nv_bfloat16 h[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) h[j] = __float2bfloat16_rn(y[j]);
    *reinterpret_cast<int4*>(static_cast<__nv_bfloat16*>(out) + base) =
        *reinterpret_cast<const int4*>(h);
  } else {
    __align__(8) int8_t qv[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float r = rintf(__fdiv_rn(y[j], __ldg(s1 + cg * CPT + j)));
      qv[j] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
    }
    *reinterpret_cast<int2*>(static_cast<int8_t*>(out) + base) =
        *reinterpret_cast<const int2*>(qv);
  }
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 out, 1 = bf16 out, 2 = int8 requant with s1.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv0_s2d_i8(const void* x, const void* w, const void* scale,
                            const void* bias, const void* s1, void* out,
                            int B, int H, int W, int mode, void* stream) {
  const dim3 grid((W / 2 + TPX - 1) / TPX, H / 2, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int* wp = static_cast<const int*>(w);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  const float* s1p = static_cast<const float*>(s1);
  switch (mode) {
    case 0: conv0_s2d_i8_kernel<0><<<grid, THREADS, 0, st>>>(xp, wp, sp, bp, s1p, out, H, W); break;
    case 1: conv0_s2d_i8_kernel<1><<<grid, THREADS, 0, st>>>(xp, wp, sp, bp, s1p, out, H, W); break;
    case 2: conv0_s2d_i8_kernel<2><<<grid, THREADS, 0, st>>>(xp, wp, sp, bp, s1p, out, H, W); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
