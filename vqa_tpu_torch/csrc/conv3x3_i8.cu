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
// 4608 MACs per output, well above the ridge, so it is compute-bound. This
// first version runs on the CUDA cores with __dp4a (4 MACs per instruction),
// not on the int8 tensor cores (mma.sync / wgmma s8 is later work). Design:
//   * a block owns an 8 x 16 tile of conv outputs x 64 output channels;
//     thread t holds a 2 x 2 output quad x 8 channels (32 int32 accumulators),
//     so a pooled store needs no cross-thread exchange;
//   * the input halo (10 x 18 pixels) and the weights for one 32-channel chunk
//     of C_in live in shared memory; the halo's pixel stride is padded to 9
//     words so the four quads of a warp hit distinct banks, and a thread's 8
//     channels are {4cg..4cg+3, 32+4cg..32+4cg+3}, so its two 16-byte weight
//     loads are contiguous across the warp (no bank conflicts);
//   * C_in must be a multiple of 32 and C_out of 64 (VGG: 64..512).
//
// Epilogue, bit-for-bit the plain PyTorch version in ops/conv_hpack.py:
//   acc = POOL ? max over the 2x2 quad (int32, exact: every later step is
//         non-decreasing because scale > 0) : acc
//   y   = relu(__fadd_rn(__fmul_rn(float(acc), scale[o]), bias[o]))
//   MODE 0: f32, MODE 1: bf16 (round to nearest even),
//   MODE 2: int8 clip(rint(__fdiv_rn(y, s_next[o])), -127, 127).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16;            // conv-output tile (pre-pool)
constexpr int OCB = 64;                   // output channels per block
constexpr int CK = 32;                    // input channels per shared-memory chunk
constexpr int KW = CK / 4;                // char4 words per pixel per chunk
constexpr int PIXW = KW + 1;              // padded pixel stride (words)
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int THREADS = 256;              // (TH/2)*(TW/2) quads x 8 channel groups

__device__ __forceinline__ float epi(int a, float s, float b) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(a), s), b);
  return v > 0.f ? v : 0.f;
}

__device__ __forceinline__ int8_t requant(float y, float s) {
  const float r = rintf(__fdiv_rn(y, s));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// Store 4 consecutive channels starting at element offset `off`.
template <int MODE>
__device__ __forceinline__ void store4(void* out, size_t off, const float* y,
                                       const float* s_next, int o) {
  if (MODE == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else if (MODE == 1) {
    __align__(8) __nv_bfloat16 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(y[j]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + off) =
        *reinterpret_cast<const uint2*>(h);
  } else {
    __align__(4) int8_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = requant(y[j], __ldg(s_next + o + j));
    *reinterpret_cast<int*>(static_cast<int8_t*>(out) + off) =
        *reinterpret_cast<const int*>(q);
  }
}

template <int MODE, bool POOL>
__global__ void __launch_bounds__(THREADS) conv3x3_i8_kernel(
    const int8_t* __restrict__ x,      // [B, H, W, C] int8
    const int* __restrict__ w,         // [9][C/4][Cout] char4 words
    const float* __restrict__ scale,   // [Cout]
    const float* __restrict__ bias,    // [Cout]
    const float* __restrict__ s_next,  // [Cout] (MODE 2)
    void* __restrict__ out,            // [B, Ho, Wo, Cout]
    int H, int W, int C, int Cout) {
  __shared__ int xs[HALO_H * HALO_W * PIXW];
  __shared__ __align__(16) int ws[9 * KW * OCB];

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const int oc0 = blockIdx.y * OCB, b = blockIdx.z;
  const int t = threadIdx.x, cg = t & 7, quad = t >> 3;
  const int qy = quad >> 3, qx = quad & 7;
  const int c4 = C / 4;

  int acc[4][8];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[d][j] = 0;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    for (int i = t; i < HALO_H * HALO_W * 2; i += THREADS) {
      const int pix = i >> 1, half = i & 1;
      const int iy = ty0 - 1 + pix / HALO_W, ix = tx0 - 1 + pix % HALO_W;
      int4 v = make_int4(0, 0, 0, 0);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = __ldg(reinterpret_cast<const int4*>(
            x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C + c0 + half * 16));
      int* dst = &xs[pix * PIXW + half * 4];
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    for (int i = t; i < 9 * KW * (OCB / 4); i += THREADS) {
      const int row = i / (OCB / 4), col = i % (OCB / 4);
      const int tap = row / KW, k = row % KW;
      *reinterpret_cast<int4*>(&ws[row * OCB + col * 4]) = __ldg(reinterpret_cast<const int4*>(
          w + (static_cast<size_t>(tap) * c4 + c0 / 4 + k) * Cout + oc0 + col * 4));
    }
    __syncthreads();

#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int* wrow = &ws[(ky * 3 + kx) * KW * OCB];
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const int4 wa = *reinterpret_cast<const int4*>(&wrow[k * OCB + cg * 4]);
          const int4 wb = *reinterpret_cast<const int4*>(&wrow[k * OCB + 32 + cg * 4]);
          const int wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int py = 2 * qy + (d >> 1) + ky, px = 2 * qx + (d & 1) + kx;
            const int xv = xs[(py * HALO_W + px) * PIXW + k];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[d][j] = __dp4a(xv, wv[j], acc[d][j]);
          }
        }
      }
    }
  }

  // channels of this thread: j < 4 -> oc0 + 4cg + j, j >= 4 -> oc0 + 32 + 4cg + j - 4
  const int oa = oc0 + cg * 4, ob = oc0 + 32 + cg * 4;
  float sc[8], bs[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = __ldg(scale + oa + j); bs[j] = __ldg(bias + oa + j);
    sc[j + 4] = __ldg(scale + ob + j); bs[j + 4] = __ldg(bias + ob + j);
  }
  if (POOL) {
    const int Ho = H / 2, Wo = W / 2;
    const int py = ty0 / 2 + qy, px = tx0 / 2 + qx;
    if (py >= Ho || px >= Wo) return;
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j] = epi(max(max(acc[0][j], acc[1][j]), max(acc[2][j], acc[3][j])), sc[j], bs[j]);
    const size_t base = ((static_cast<size_t>(b) * Ho + py) * Wo + px) * Cout;
    store4<MODE>(out, base + oa, y, s_next, oa);
    store4<MODE>(out, base + ob, y + 4, s_next, ob);
  } else {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int oy = ty0 + 2 * qy + (d >> 1), ox = tx0 + 2 * qx + (d & 1);
      if (oy >= H || ox >= W) continue;
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = epi(acc[d][j], sc[j], bs[j]);
      const size_t base = ((static_cast<size_t>(b) * H + oy) * W + ox) * Cout;
      store4<MODE>(out, base + oa, y, s_next, oa);
      store4<MODE>(out, base + ob, y + 4, s_next, ob);
    }
  }
}

template <int MODE, bool POOL>
void launch(dim3 grid, cudaStream_t st, const void* x, const void* w, const void* scale,
            const void* bias, const void* s_next, void* out, int H, int W, int C, int Cout) {
  conv3x3_i8_kernel<MODE, POOL><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s_next), out, H, W, C, Cout);
}

}  // namespace

extern "C" const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mode: 0 = f32 out, 1 = bf16 out, 2 = int8 requant with s_next; pool: 0/1.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int conv3x3_i8(const void* x, const void* w, const void* scale,
                          const void* bias, const void* s_next, void* out,
                          int B, int H, int W, int C, int Cout, int mode, int pool,
                          void* stream) {
  if (C % CK != 0 || Cout % OCB != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), Cout / OCB, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sel = mode * 2 + (pool ? 1 : 0);
  switch (sel) {
    case 0: launch<0, false>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout); break;
    case 1: launch<0, true>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout); break;
    case 2: launch<1, false>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout); break;
    case 3: launch<1, true>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout); break;
    case 4: launch<2, false>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout); break;
    case 5: launch<2, true>(grid, st, x, w, scale, bias, s_next, out, H, W, C, Cout); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
